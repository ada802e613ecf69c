// The join-aggregate lane's weighted fold (H16), built for Hopper (sm_90a)
// with the other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it).
//
// H16 px_join_agg_fold  replaces the weighted segment sums of the left-side
//    program of pixie_tpu/parallel/pipeline.py _run_left_join_agg
//    (:2664-2732): w = nR[jk], mask &= w > 0, seg_sum(where(mask, w, 0)) for
//    the join's count, seg_sum(val * wm) for each left sum/mean argument and
//    seg_sum(where(mask, sumR[jk], 0)) for each right one. The join's pairs
//    are never built: a left row stands for its nR[jk] matching right rows.
//    Operation, for every row r with mask[r] and w = n_right[jk[r]] > 0:
//      acc[0, g]           += w
//      acc[1 + i, g]       += left_vals[i][r] * w      (i < S_l)
//      acc[1 + S_l + j, g] += right_sums[j, jk[r]]      (j < S_r)
//    with g = gids[r], and eff_mask[r] = mask[r] && w > 0 (when asked for),
//    the mask that the left and right min/max specs then fold under (H11).
//    A key outside [0, K) weighs 0; a gid outside [0, cap) adds nothing. A
//    row that fails the mask, or whose key has no right match, adds
//    nothing: a non-finite value there cannot reach its group's sum (the
//    reference multiplies it by a zero weight, which gives NaN for inf and
//    NaN: PERF.md's Fault-7). val * w is one __dmul_rn, so nvcc cannot fuse
//    it into the add: the product equals the reference's bit for bit, and
//    only the order of the additions differs.
//
//    Design. The rows are read where the fold staged them (rows.cuh's typed
//    loads, 8 rows a thread as 16-byte vectors with the streaming hint):
//    jk as uint8, uint16 or int32 plus its frame-of-reference offset,
//    the gids as uint8, uint16 or int32, the left sums as separate f64
//    columns; the effective mask is written 8 bytes a thread. The per-key
//    statistics (n_right and the S_r right sums, K keys) are staged in
//    shared memory when they fit beside the lane's cells, else read through
//    the read-only path (__ldg). A launch takes up to kJaMaxRows of the
//    1 + S_l + S_r output rows (kJaWarpRows in the first two lanes), each
//    launch reading the keys and gids again. Its lane, as H2's
//    (hopper_kernels.cu, ops/kernels/__init__.py h2_lane) for cap <= 64:
//    (a) private: R rows times cap's bucket of 8, 16, 32 or 64 is at most 64
//        cells; each thread's cells in shared memory, no atomics (config 8:
//        3 rows x 16 groups);
//    (b) warps: the other shapes up to 64 groups; a thread merges its 8
//        rows' runs of equal gids, a warp adds equal gids by shuffles in a
//        fixed tree;
//    in both, each CTA writes its [R, cap] partial to a scratch and the
//    last CTA (a per-stream ticket) adds the partials in CTA order into
//    acc (read at the kernel's start): no f64 atomic, no fill launch, the
//    same bits on every run; a grid of one CTA adds its cells into acc
//    itself. A launch of a row or fewer a thread takes one row a thread.
//    Above 64 groups: (c) shared: the [R, cap] partial in shared memory
//    (f64 shared atomics), flushed with one global atomic a non-zero cell;
//    (d) global: one global f64 atomic a row and cell.
//
//    What bounds it on an H100: jk, gids and mask are read once and eff_mask
//    written once (4 bytes a row as config 8 stages them, 10 as int32), plus
//    8 bytes a row for each left value: 12 bytes a row at S_l = 1. The
//    statistics and acc are small at the lane's shapes (K = 16 services, 16
//    groups). Bytes-bound in lanes (a) and (b); with few groups in (c) and
//    (d) the serialised atomics on the same cells set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "rows.cuh"

namespace {

using px::allow_smem;

constexpr int kJ = px::kRowsPerThread;
constexpr int kJaMaxRows = 32;       // ops/kernels/__init__.py JOIN_AGG_MAX_ROWS
constexpr int kJaWarpRows = 4;       // rows a launch of lanes (a) and (b)
constexpr int kJaPrivMaxCells = 64;  // lane (a): rows x cap's bucket
constexpr int kJaWarpThreads = 512;
constexpr int kJaMaxGroups = 64;     // lanes (a) and (b)

enum JaRowKind { kCountRow = 0, kLeftRow = 1, kRightRow = 2 };
enum JaLane { kPrivate = 0, kWarps = 1, kShared = 2, kGlobal = 3 };

struct JaArgs {
  const void* jk;
  int jk_kind;
  long long jk_off;
  const void* gids;
  int gid_kind;
  const unsigned char* mask;
  long long n;
  const double* n_right;     // [K]
  int K;
  const double* right_sums;  // [S_r, K]
  int S_r;
  int R;                              // output rows of this launch
  int kind[kJaMaxRows];               // JaRowKind of each
  const double* left[kJaMaxRows];     // a left row's column
  int right[kJaMaxRows];              // a right row's row of right_sums
  int cap;
  double* acc;           // this launch's first output row: [R, cap], added to
  unsigned char* eff;    // the effective mask, or null
  int vec;               // bit 0 jk, 1 gids, 2 mask, 3 eff take 8-row vectors
  unsigned int vec_left;  // bit r: row r's column takes 16-byte loads
  int shared_stats;      // n_right and right_sums staged in shared memory
  double* partials;      // lanes (a), (b): [CTAs, R, cap]
  unsigned int* ticket;
  long long* probe;      // null, or int64 [4]: CTA 0's clocks at the start and
                         // after the load, the fold and the combine
};

__device__ __forceinline__ void ja_clock(const JaArgs& a, int k) {
  if (a.probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) a.probe[k] = clock64();
}

// Stages [n_right | right_sums] into ``st`` when the launch keeps them in
// shared memory (the caller synchronises).
__device__ __forceinline__ void ja_stage_stats(const JaArgs& a, double* st) {
  if (!a.shared_stats) return;
  const long long nstats = (long long)(1 + a.S_r) * a.K;
  for (long long c = threadIdx.x; c < nstats; c += blockDim.x) {
    st[c] = c < a.K ? __ldg(a.n_right + c) : __ldg(a.right_sums + (c - a.K));
  }
}

__device__ __forceinline__ double ja_weight(const JaArgs& a, const double* st, int k) {
  return a.shared_stats ? st[k] : __ldg(a.n_right + k);
}

__device__ __forceinline__ double ja_right(const JaArgs& a, const double* st, int j, int k) {
  const long long s = (long long)j * a.K + k;
  return a.shared_stats ? st[a.K + s] : __ldg(a.right_sums + s);
}

// A thread's 8 rows as loaded, every load issued before any is used (one
// round trip to memory a chunk): the raw keys and gids (uint8, uint16 or
// int32, in 32 bits), the mask's 8 bytes and, with R > 0, each left row's
// 8 values.
struct JaKeys {
  unsigned int key[kJ], gid[kJ];
  unsigned int mw[2];
};

template <int R>
struct JaRows : JaKeys {
  unsigned long long val[R][kJ];
};

// 8 rows of a uint8, uint16 or int32 column from i0 (0 past n), in 32 bits.
__device__ __forceinline__ void ja_load32x8(const void* __restrict__ p, int kind, long long i0,
                                            long long n, bool vec, unsigned int (&v)[kJ]) {
  if (vec && i0 + kJ <= n) {
    if (kind == px::kU8) {
      const uint2 w = __ldcs(reinterpret_cast<const uint2*>((const unsigned char*)p + i0));
#pragma unroll
      for (int j = 0; j < kJ; ++j) v[j] = ((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xFFu;
    } else if (kind == px::kU16) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>((const unsigned short*)p + i0));
      const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < kJ; ++j) v[j] = (u[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
    } else {
      const uint4 x = __ldcs(reinterpret_cast<const uint4*>((const unsigned int*)p + i0));
      const uint4 y = __ldcs(reinterpret_cast<const uint4*>((const unsigned int*)p + i0 + 4));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const long long i = i0 + j;
      v[j] = i >= n ? 0u
             : kind == px::kU8  ? (unsigned int)((const unsigned char*)p)[i]
             : kind == px::kU16 ? (unsigned int)((const unsigned short*)p)[i]
                                : ((const unsigned int*)p)[i];
    }
  }
}

__device__ __forceinline__ void ja_load_keys(const JaArgs& a, long long i0, JaKeys& x) {
  ja_load32x8(a.jk, a.jk_kind, i0, a.n, a.vec & 1, x.key);
  ja_load32x8(a.gids, a.gid_kind, i0, a.n, (a.vec >> 1) & 1, x.gid);
  x.mw[0] = x.mw[1] = 0xFFFFFFFFu;
  if (a.mask != nullptr && i0 + kJ <= a.n && ((a.vec >> 2) & 1)) {
    const uint2 m = __ldcs(reinterpret_cast<const uint2*>(a.mask + i0));
    x.mw[0] = m.x;
    x.mw[1] = m.y;
  } else if (a.mask != nullptr) {
    x.mw[0] = x.mw[1] = 0u;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (i0 + j < a.n && a.mask[i0 + j]) x.mw[j >> 2] |= 0xFFu << (8 * (j & 3));
    }
  }
}

template <int R>
__device__ __forceinline__ void ja_load_rows(const JaArgs& a, long long i0, JaRows<R>& x) {
  ja_load_keys(a, i0, x);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (a.kind[r] == kLeftRow) {
      px::load_vals8(a.left[r], px::kF64, i0, a.n, (a.vec_left >> r) & 1u, x.val[r]);
    }
  }
}

// From the loaded rows i0 .. i0 + 7: k[j] the row's key (0 when it adds
// nothing), w[j] its weight (0 when masked, past n, a key outside [0, K)
// or no match), g[j] its gid when w > 0 and the gid lies in [0, cap), else
// -1. Writes the effective mask (w > 0) when asked for.
__device__ __forceinline__ void ja_decode(const JaArgs& a, const double* st, long long i0,
                                          const JaKeys& x, int (&k)[kJ], double (&w)[kJ],
                                          int (&g)[kJ]) {
  unsigned int ew[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const long long raw = a.jk_kind == px::kI32 ? (long long)(int)x.key[j] : (long long)x.key[j];
    const long long key = raw + a.jk_off;
    const bool live = i0 + j < a.n && ((x.mw[j >> 2] >> (8 * (j & 3))) & 0xFFu) != 0u &&
                      key >= 0 && key < a.K;
    k[j] = live ? (int)key : 0;
    w[j] = live ? ja_weight(a, st, k[j]) : 0.0;
    const bool eff = w[j] > 0.0;
    if (eff) ew[j >> 2] |= 1u << (8 * (j & 3));
    const int gg = (int)x.gid[j];  // int32 as it is; uint8 and uint16 zero-extended
    g[j] = eff && gg >= 0 && gg < a.cap ? gg : -1;
  }
  if (a.eff != nullptr) {
    if (i0 + kJ <= a.n && ((a.vec >> 3) & 1)) {
      *reinterpret_cast<uint2*>(a.eff + i0) = make_uint2(ew[0], ew[1]);
    } else {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (i0 + j < a.n) a.eff[i0 + j] = (ew[j >> 2] >> (8 * (j & 3))) & 1u;
      }
    }
  }
}

// Output row r's term of the 8 rows (0 for a row that adds nothing); a left
// row's values in ``val``.
__device__ __forceinline__ void ja_terms8(const JaArgs& a, const double* st, int r,
                                          const unsigned long long (&val)[kJ],
                                          const int (&k)[kJ], const double (&w)[kJ],
                                          const int (&g)[kJ], double (&x)[kJ]) {
  if (a.kind[r] == kLeftRow) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      x[j] = g[j] >= 0 ? __dmul_rn(__longlong_as_double((long long)val[j]), w[j]) : 0.0;
    }
  } else if (a.kind[r] == kRightRow) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) x[j] = g[j] >= 0 ? ja_right(a, st, a.right[r], k[j]) : 0.0;
  } else {
#pragma unroll
    for (int j = 0; j < kJ; ++j) x[j] = g[j] >= 0 ? w[j] : 0.0;
  }
}

// After each CTA wrote its [cells] partial (a.partials[blockIdx.x]): the
// last CTA to take a ticket adds every CTA's partial in CTA order (k
// threads a cell each adding every k-th partial, sixteen loads in flight,
// then the cell's thread their k sums in order) and adds the cell's sum
// into acc; it sets the ticket back to 0 (H2's finish_partials, with acc
// added to). ``scratch``: blockDim doubles of shared memory. A grid of one
// CTA adds its cells ``own`` (shared memory) into acc at once: no partial,
// no fence, no ticket. ``held``: acc[threadIdx.x] as the thread read it at
// the kernel's start (cells <= blockDim; no CTA writes acc before this), so
// the write waits for no load.
__device__ void ja_finish(const JaArgs& a, int cells, double* scratch, const double* own,
                          double held) {
  constexpr int kFly = 16;
  __shared__ bool sh_last;
  __syncthreads();
  const int me = threadIdx.x;
  if (gridDim.x == 1) {
    if (me < cells) a.acc[me] = __dadd_rn(held, own[me]);
    return;
  }
  if (threadIdx.x == 0) {
    __threadfence();
    sh_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    if (sh_last) __threadfence();
  }
  __syncthreads();
  if (!sh_last) return;
  int k = 1;
  while (2 * k * cells <= (int)blockDim.x && 2 * k <= 32) k *= 2;
  const int grid = (int)gridDim.x;
  for (int t = threadIdx.x; t < k * cells; t += blockDim.x) {
    const int c = t % cells;
    double sum = 0.0;
    for (int b = t / cells; b < grid; b += kFly * k) {
      double v[kFly];
#pragma unroll
      for (int q = 0; q < kFly; ++q) {
        const int bq = b + q * k;
        v[q] = bq < grid ? __ldcg(&a.partials[(long long)bq * cells + c]) : 0.0;
      }
#pragma unroll
      for (int q = 0; q < kFly; ++q) sum = __dadd_rn(sum, v[q]);
    }
    scratch[t] = sum;
  }
  __syncthreads();
  if (me < cells) {
    double sum = 0.0;
    for (int p = 0; p < k; ++p) sum = __dadd_rn(sum, scratch[p * cells + me]);
    a.acc[me] = __dadd_rn(held, sum);
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// acc[threadIdx.x] for ja_finish, read at the kernel's start (0 past the
// launch's cells).
__device__ __forceinline__ double ja_held(const JaArgs& a, int cells) {
  return (int)threadIdx.x < cells ? __ldcg(a.acc + threadIdx.x) : 0.0;
}

// One row i of a thin launch (a row or fewer a thread): its key, weight
// and gid as ja_decode gives them, the effective mask written, then each
// output row's term added into the thread's private cells (``cell(r, g)``).
template <int R, typename Cell>
__device__ __forceinline__ void ja_thin_row(const JaArgs& a, const double* st, long long i,
                                            Cell cell) {
  const auto load = [&](const void* p, int kind) -> long long {
    return kind == px::kU8    ? (long long)((const unsigned char*)p)[i]
           : kind == px::kU16 ? (long long)((const unsigned short*)p)[i]
                              : (long long)((const int*)p)[i];
  };
  const long long key = load(a.jk, a.jk_kind) + a.jk_off;
  const long long gg = load(a.gids, a.gid_kind);
  const bool live = (a.mask == nullptr || a.mask[i]) && key >= 0 && key < a.K;
  const int k = live ? (int)key : 0;
  const double w = live ? ja_weight(a, st, k) : 0.0;
  if (a.eff != nullptr) a.eff[i] = w > 0.0;
  if (!(w > 0.0) || gg < 0 || gg >= a.cap) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double x = a.kind[r] == kLeftRow ? __dmul_rn(a.left[r][i], w)
                     : a.kind[r] == kRightRow ? ja_right(a, st, a.right[r], k)
                                              : w;
    double* c = cell(r, (int)gg);
    *c = __dadd_rn(*c, x);
  }
}

// (a) R * SB <= 64 cells (SB: cap rounded up to 8, 16, 32 or 64): each
// thread's cells private in shared memory, laid out [cell][thread] (no bank
// conflicts, no atomics), its rows added in row order; then each cell's
// threads added by a warp in a fixed order into the CTA's partial, and the
// partials as ja_finish adds them. One CTA an SM: 512 threads up to 48
// cells, 256 above (the cells fill the SM's shared memory).
template <int R, int SB>
struct JaPriv {
  static constexpr int kCells = R * SB;
  static constexpr int kThreads = kCells <= 48 ? 512 : 256;
};

template <int R, int SB>
__global__ void __launch_bounds__(JaPriv<R, SB>::kThreads, 1) ja_private_kernel(const JaArgs a) {
  constexpr int T = JaPriv<R, SB>::kThreads, CELLS = R * SB;
  extern __shared__ double sh_ja_priv[];  // [CELLS][T], [T] the tail's scratch, the statistics
  double* own = sh_ja_priv + CELLS * T;
  double* st = own + T;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = T / 32;
  ja_clock(a, 0);
  const double held = ja_held(a, R * a.cap);
#pragma unroll
  for (int c = 0; c < CELLS; ++c) sh_ja_priv[c * T + t] = 0.0;
  ja_stage_stats(a, st);
  __syncthreads();
  ja_clock(a, 1);
  const long long stride = (long long)gridDim.x * T;
  if (a.n <= stride) {
    // A thin launch (join8_team_agg's 256-row block): a row a thread, in
    // short code: each thread's chain is one row's loads, lookups and adds.
    const long long i = (long long)blockIdx.x * T + t;
    if (i < a.n) {
      ja_thin_row<R>(a, st, i, [&](int r, int g) { return &sh_ja_priv[(r * SB + g) * T + t]; });
    }
  } else {
    const long long chunks = (a.n + kJ - 1) / kJ;
    for (long long ch = (long long)blockIdx.x * T + t; ch < chunks; ch += stride) {
      const long long i0 = ch * kJ;
      JaRows<R> rows;
      ja_load_rows<R>(a, i0, rows);
      int k[kJ], g[kJ];
      double w[kJ];
      ja_decode(a, st, i0, rows, k, w, g);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        double x[kJ];
        ja_terms8(a, st, r, rows.val[r], k, w, g, x);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (g[j] >= 0) {
            double* cell = &sh_ja_priv[(r * SB + g[j]) * T + t];
            *cell = __dadd_rn(*cell, x[j]);
          }
        }
      }
    }
  }
  __syncthreads();
  ja_clock(a, 2);
  // Cell c (row c / SB, group c % SB) by warp c % warps: each lane adds its
  // T / 32 threads in order, then a fixed shuffle tree.
  for (int c = warp; c < CELLS; c += warps) {
    double sum = 0.0;
#pragma unroll
    for (int q = 0; q < T / 32; ++q) sum = __dadd_rn(sum, sh_ja_priv[c * T + q * 32 + lane]);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) sum = __dadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, w));
    const int r = c / SB, s = c % SB;
    if (lane == 0 && s < a.cap) {
      const int o = r * a.cap + s;
      if (gridDim.x == 1) {
        own[o] = sum;
      } else {
        __stcg(&a.partials[(long long)blockIdx.x * R * a.cap + o], sum);
      }
    }
  }
  ja_finish(a, R * a.cap, own, own, held);
  ja_clock(a, 3);
}

// (b) cap <= 64, more cells than (a) takes: a thread merges its 8 rows'
// runs of equal gids in registers; then, for each of its 8 rows at once,
// the warp finds the lanes that hold the same gid (a ballot of each of the
// gid's bits) and adds their sums in a fixed tree, so the lowest lane of
// each gid adds its sum into the warp's own [R, cap] cells in shared
// memory; the CTA adds its warps in order into its partial, and the
// partials as ja_finish adds them (H2's warp lane).
template <int R>
__global__ void __launch_bounds__(kJaWarpThreads, 1) ja_warp_kernel(const JaArgs a) {
  constexpr unsigned int kAll = 0xFFFFFFFFu;
  extern __shared__ double sh_ja_warp[];  // [warps][R][cap] (at least blockDim), the statistics
  const int S = a.cap, cells = R * S;
  const int nb = S > 1 ? 32 - __clz(S - 1) : 0;  // bits of a gid
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  double* st = sh_ja_warp + max(warps * cells, (int)blockDim.x);
  ja_clock(a, 0);
  const double held = ja_held(a, cells);
  for (int c = threadIdx.x; c < warps * cells; c += blockDim.x) sh_ja_warp[c] = 0.0;
  ja_stage_stats(a, st);
  __syncthreads();
  ja_clock(a, 1);
  double* mine = sh_ja_warp + warp * cells;
  const long long chunks = (a.n + kJ - 1) / kJ;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // Every lane of a warp runs the same trips (the shuffles need them all).
  for (long long c0 = (long long)blockIdx.x * blockDim.x + warp * 32; c0 < chunks; c0 += stride) {
    const long long i0 = (c0 + lane) * kJ;
    JaRows<R> rows;
    ja_load_rows<R>(a, i0, rows);
    int k[kJ], g[kJ];
    double w[kJ], x[R][kJ];
    ja_decode(a, st, i0, rows, k, w, g);
#pragma unroll
    for (int r = 0; r < R; ++r) ja_terms8(a, st, r, rows.val[r], k, w, g, x[r]);
#pragma unroll
    for (int j = 0; j + 1 < kJ; ++j) {  // runs of equal gids carry their sum on
      if (g[j] >= 0 && g[j] == g[j + 1]) {
#pragma unroll
        for (int r = 0; r < R; ++r) x[r][j + 1] = __dadd_rn(x[r][j], x[r][j + 1]);
        g[j] = -1;
      }
    }
    unsigned int rest[kJ], lead = 0u;  // lead: bit j, this lane adds row j's gid
    int rank[kJ];
    int most = 0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      unsigned int p = __ballot_sync(kAll, g[j] >= 0);
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        if (b < nb) {
          const bool bit = (g[j] >> b) & 1;
          const unsigned int m = __ballot_sync(kAll, bit);
          p &= bit ? m : ~m;
        }
      }
      if (g[j] < 0) p = 0u;
      rank[j] = __popc(p & below);
      rest[j] = p & (0xFFFFFFFEu << lane);
      if (g[j] >= 0 && rank[j] == 0) lead |= 1u << j;
      most = max(most, __popc(p));
    }
    most = (int)__reduce_max_sync(kAll, (unsigned int)most);
    for (int span = 1; span < most; span <<= 1) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int next = __ffs(rest[j]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const double t = __shfl_sync(kAll, x[r][j], (next - 1) & 31);
          if (next) x[r][j] = __dadd_rn(x[r][j], t);
        }
        rest[j] &= __ballot_sync(kAll, (rank[j] & 1) == 0);
        rank[j] >>= 1;
      }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if ((lead >> j) & 1u) {
#pragma unroll
        for (int r = 0; r < R; ++r) mine[r * S + g[j]] = __dadd_rn(mine[r * S + g[j]], x[r][j]);
      }
    }
  }
  __syncthreads();
  ja_clock(a, 2);
  // Each cell's warps added in order: into the CTA's partial, or with one
  // CTA into the cell's own slot of warp 0 (read by this thread alone).
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    double t = 0.0;
    for (int w = 0; w < warps; ++w) t = __dadd_rn(t, sh_ja_warp[w * cells + c]);
    if (gridDim.x == 1) {
      sh_ja_warp[c] = t;
    } else {
      __stcg(&a.partials[(long long)blockIdx.x * cells + c], t);
    }
  }
  ja_finish(a, cells, sh_ja_warp, sh_ja_warp, held);
  ja_clock(a, 3);
}

// (c) the [R, cap] partial in shared memory, one shared f64 atomic a row and
// cell, one global atomic a CTA and non-zero cell at the flush; (d) one
// global f64 atomic a row and cell straight into acc.
__global__ void __launch_bounds__(px::kThreads) ja_atomic_kernel(const JaArgs a, int use_shared) {
  extern __shared__ double sh_ja_atomic[];  // [R, cap] in (c), then the statistics
  const long long cells = (long long)a.R * a.cap;
  double* part = use_shared ? sh_ja_atomic : a.acc;
  double* st = sh_ja_atomic + (use_shared ? cells : 0);
  ja_clock(a, 0);
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) sh_ja_atomic[c] = 0.0;
  }
  ja_stage_stats(a, st);
  __syncthreads();
  ja_clock(a, 1);
  const long long chunks = (a.n + kJ - 1) / kJ;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < chunks;
       ch += stride) {
    const long long i0 = ch * kJ;
    JaKeys keys;
    ja_load_keys(a, i0, keys);
    int k[kJ], g[kJ];
    double w[kJ];
    ja_decode(a, st, i0, keys, k, w, g);
    for (int r = 0; r < a.R; ++r) {
      unsigned long long val[kJ];
      if (a.kind[r] == kLeftRow) {
        px::load_vals8(a.left[r], px::kF64, i0, a.n, (a.vec_left >> r) & 1u, val);
      }
      double x[kJ];
      ja_terms8(a, st, r, val, k, w, g, x);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (g[j] >= 0) atomicAdd(part + (long long)r * a.cap + g[j], x[j]);
      }
    }
  }
  __syncthreads();
  ja_clock(a, 2);
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      const double v = sh_ja_atomic[c];
      if (v != 0.0) atomicAdd(a.acc + c, v);  // NaN != 0: a NaN partial flushes
    }
  }
  ja_clock(a, 3);
}

int ja_bucket(int cap) { return cap <= 8 ? 8 : cap <= 16 ? 16 : cap <= 32 ? 32 : 64; }

// Threads and dynamic shared bytes of a launch of ``lane`` over R rows and
// cap groups, without the statistics; CTAs an SM it is laid out for.
void ja_shape(int lane, int R, int cap, int* threads, size_t* smem, int* ctas_per_sm) {
  *ctas_per_sm = 1;
  if (lane == kPrivate) {
    const int cells = R * ja_bucket(cap);
    *threads = cells <= 48 ? 512 : 256;  // JaPriv
    *smem = (size_t)(cells + 1) * *threads * sizeof(double);
  } else if (lane == kWarps) {
    const int cells = (kJaWarpThreads / 32) * R * cap;
    *threads = kJaWarpThreads;
    *smem = (size_t)(cells > kJaWarpThreads ? cells : kJaWarpThreads) * sizeof(double);
  } else {
    *threads = px::kThreads;
    *smem = lane == kShared ? (size_t)R * cap * sizeof(double) : 0;
    *ctas_per_sm = lane == kShared ? 2 : 8;
  }
}

// Whether the statistics are staged: they fit beside the lane's cells in
// the shared memory its CTAs an SM leave each.
int ja_shared_stats(int lane, int R, int cap, int K, int S_r, int optin) {
  int threads, ctas;
  size_t smem;
  ja_shape(lane, R, cap, &threads, &smem, &ctas);
  const size_t stats = (size_t)(1 + S_r) * K * sizeof(double);
  return smem + stats <= (size_t)optin / ctas;
}

template <typename Kernel>
cudaError_t ja_launch(Kernel kernel, const JaArgs& a, int grid, int threads, size_t smem,
                      cudaStream_t st) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int SB>
cudaError_t ja_private_sb(const JaArgs& a, int grid, int threads, size_t smem, cudaStream_t st) {
  switch (a.R) {
    case 1: return ja_launch(ja_private_kernel<1, SB>, a, grid, threads, smem, st);
    case 2: return ja_launch(ja_private_kernel<2, (SB <= 32 ? SB : 32)>, a, grid, threads, smem,
                             st);
    case 3: return ja_launch(ja_private_kernel<3, (SB <= 16 ? SB : 16)>, a, grid, threads, smem,
                             st);
    default: return ja_launch(ja_private_kernel<4, (SB <= 16 ? SB : 16)>, a, grid, threads, smem,
                              st);
  }
}

}  // namespace

extern "C" {

// One launch of H16 over rows [0, n) for R of the output rows: row r is the
// count (kinds[r] 0), a left sum (1: the f64 column lefts[r]) or a right sum
// (2: row rights[r] of right_sums). jk: jk_kind (rows.cuh RowKind: uint8,
// uint16 or int32) plus jk_off; gids: gid_kind (uint8, uint16 or
// int32); mask: bool [n] or null; n_right: f64 [K]; right_sums: f64 [S_r,
// K]; acc: f64 [R, cap] (this launch's rows), added to in place; eff: bool
// [n] out, or null. lane: 0 private, 1 warps (cap <= 64, R <= 4, grid CTAs,
// partials f64 [grid, R, cap] and a zeroed uint32 ticket), 2 shared, 3
// global (grid CTAs); optin: the device's opt-in shared bytes a block; probe:
// int64 [4] or null.
int px_join_agg_fold(const void* jk, int jk_kind, long long jk_off, const void* gids,
                     int gid_kind, const void* mask, long long n, const void* n_right, int K,
                     const void* right_sums, int S_r, const int* kinds, const void* const* lefts,
                     const int* rights, int R, void* acc, int cap, void* eff, int lane, int grid,
                     int optin, void* partials, void* ticket, void* probe, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (R <= 0 || R > kJaMaxRows || cap < 0 || K < 0 || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (lane <= kWarps && (cap < 1 || cap > kJaMaxGroups || R > kJaWarpRows ||
                         partials == nullptr || ticket == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (lane == kPrivate && R * ja_bucket(cap) > kJaPrivMaxCells) return (int)cudaErrorInvalidValue;
  const auto narrow_kind = [](int kind) {
    return kind == px::kU8 || kind == px::kU16 || kind == px::kI32;
  };
  if (!narrow_kind(jk_kind) || !narrow_kind(gid_kind)) return (int)cudaErrorInvalidValue;
  JaArgs a = {};
  a.jk = jk;
  a.jk_kind = jk_kind;
  a.jk_off = jk_off;
  a.gids = gids;
  a.gid_kind = gid_kind;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.n_right = (const double*)n_right;
  a.K = K;
  a.right_sums = (const double*)right_sums;
  a.S_r = S_r;
  a.R = R;
  for (int r = 0; r < R; ++r) {
    a.kind[r] = kinds[r];
    a.left[r] = (const double*)lefts[r];
    a.right[r] = rights[r];
    if (kinds[r] == kLeftRow && px::vec_aligned(lefts[r], px::kF64)) a.vec_left |= 1u << r;
  }
  a.cap = cap;
  a.acc = (double*)acc;
  a.eff = (unsigned char*)eff;
  a.vec = (px::vec_aligned(jk, jk_kind) ? 1 : 0) | (px::vec_aligned(gids, gid_kind) ? 2 : 0) |
          ((uintptr_t)mask % 8 == 0 ? 4 : 0) | ((uintptr_t)eff % 8 == 0 ? 8 : 0);
  a.shared_stats = ja_shared_stats(lane, R, cap, K, S_r, optin);
  a.partials = (double*)partials;
  a.ticket = (unsigned int*)ticket;
  a.probe = (long long*)probe;
  int threads, ctas;
  size_t smem;
  ja_shape(lane, R, cap, &threads, &smem, &ctas);
  if (a.shared_stats) smem += (size_t)(1 + S_r) * K * sizeof(double);
  const cudaStream_t st = (cudaStream_t)stream;
  if (lane == kPrivate) {
    switch (ja_bucket(cap)) {
      case 8: return (int)ja_private_sb<8>(a, grid, threads, smem, st);
      case 16: return (int)ja_private_sb<16>(a, grid, threads, smem, st);
      case 32: return (int)ja_private_sb<32>(a, grid, threads, smem, st);
      default: return (int)ja_private_sb<64>(a, grid, threads, smem, st);
    }
  }
  if (lane == kWarps) {
    switch (R) {
      case 1: return (int)ja_launch(ja_warp_kernel<1>, a, grid, threads, smem, st);
      case 2: return (int)ja_launch(ja_warp_kernel<2>, a, grid, threads, smem, st);
      case 3: return (int)ja_launch(ja_warp_kernel<3>, a, grid, threads, smem, st);
      default: return (int)ja_launch(ja_warp_kernel<4>, a, grid, threads, smem, st);
    }
  }
  cudaError_t err = allow_smem(ja_atomic_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ja_atomic_kernel<<<grid, threads, smem, st>>>(a, lane == kShared);
  return (int)cudaGetLastError();
}

// out: {threads a CTA, dynamic shared bytes} of px_join_agg_fold's launch
// of ``lane``.
int px_join_agg_fold_geometry(int lane, int R, int cap, int K, int S_r, int optin, int* out) {
  int threads, ctas;
  size_t smem;
  ja_shape(lane, R, cap, &threads, &smem, &ctas);
  if (ja_shared_stats(lane, R, cap, K, S_r, optin)) smem += (size_t)(1 + S_r) * K * sizeof(double);
  out[0] = threads;
  out[1] = (int)smem;
  return 0;
}

}  // extern "C"
