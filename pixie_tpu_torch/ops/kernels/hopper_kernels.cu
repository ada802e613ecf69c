// Hand-written CUDA kernels for the device fold of pixie_tpu_torch, built for
// Hopper (sm_90a) with nvcc into a shared library that has a plain C
// interface; ops/kernels/__init__.py builds it at first use and binds it with
// ctypes. Each kernel launches on the CUDA runtime's current device (the
// caller makes its tensors' device current) and on the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// H1 px_segment_rows_sum_i64  replaces pixie_tpu/ops/segment.py
//    limb_einsum_sums + reconstruct_i64 (:235, :269) and seg_count (:616):
//    per-segment sums of R rows plus one presence (row count) row, each row
//    read where the fold staged it (rows.cuh: bool, uint8, uint16, int32 or
//    int64 with a frame-of-reference offset; count's row reads nothing).
// H2 px_segment_rows_sum_f64  replaces pixie_tpu/ops/segment.py seg_sum
//    (:593) on f64 values (its _matvec_sum_f64 lane, :168): per-segment f64
//    sums of R rows, each read where the fold staged it (rows.cuh: f64, or
//    an integer row widened in registers) and summed as it is or squared
//    (variance's sum of squares, pixie_tpu/udf/builtins/math_ops.py:237).
// H3 px_log_histogram_update  replaces pixie_tpu/ops/histogram.py bin_index
//    + update (:49, :59).
// H4 px_hist_quantiles        replaces pixie_tpu/ops/histogram.py
//    quantile_values (:83).
// The sketch kernels (the hash kernel, H5-H10) are in sketch_kernels.cu,
// the launch helpers both use in common.cuh, the typed row loads in
// rows.cuh.
//
// The TPU versions ride the matrix unit through one-hot einsums and split
// int64 into 8-bit limbs so that f32 accumulation stays exact; that design
// exists only because the TPU's scatter unit is slow. Here every reduction
// adds. H3 has two lanes (ops/kernels/__init__.py h3_lane), each reading
// its values as staged (f32 or f64): (a) while an [S, nbins] partial of
// u16 counts fits a CTA, one CTA of 1024 threads an SM, 8 rows a thread,
// in clusters of 8, each counting into its own partial by shared atomics,
// the cluster adding its partials through distributed shared memory before
// one global atomic a nonzero cell; (b) global atomics, a row a thread a
// step.
// H2 has four lanes (ops/kernels/__init__.py h2_lane). Up to S = 64 no f64
// atomics: (a1) while rows x S's bucket <= 64 cells, each thread's cells
// private in shared memory; (a2) else runs of equal gids merged in a
// thread's registers and equal gids of a warp added by shuffles into the
// warp's cells; in both the CTA adds its threads or warps in a fixed order
// into its partial, and the last CTA adds the partials in a fixed order and
// writes the output (no fill launch, the same bits every run). Above: (b) a
// per-CTA [R, S] partial in shared memory, one atomic a run; (c) global
// atomics.
// H1 has three lanes (ops/kernels/__init__.py h1_lane): (a) S <= 32, each
// thread's cells private in shared memory, no atomics until the CTA's
// flush; (b) while the whole partial fits a CTA, native 32-bit shared
// atomics (a 64-bit sum as two words with a carry), then a cluster of 8
// CTAs adds its partials through distributed shared memory before one
// flush; (c) otherwise global atomics. An offset is added once a cell at
// the flush (sum(v + off) = sum(v) + count * off mod 2^64).
//
// What bounds them on an H100: H1-H3 read each input once and write a small
// [cells] output, so they are memory-bound at their bytes over the HBM rate
// when the adds keep up. H1's lane (a) costs a shared load and store a row
// and cell kind, not the 16-way atomic collisions of one partial a CTA;
// lane (b) is bound by its shared atomics (one a row for the count, one or
// two a value row); lane (c) by the L2's atomics. H2 reads R rows (a row
// over the same column as the row before, its value then its square, reads
// nothing again), the gids and the mask once (8 rows a thread, 16-byte
// streaming loads); lanes (a1) and (a2) add without f64 atomics (a shared
// f64 atomic is a compare-and-swap loop), so the loads set (a1)'s time;
// (a2)'s shuffles (about 2R a row) and the last CTA's pass over the
// partials (about 2-3 us, measured) add to it. H3's lane (a) is bound by
// log_bin's arithmetic a row (an IEEE division and logf: the rows phase,
// measured, takes about twice the loads' time), then by a shared atomic a
// row and one global atomic a nonzero cell a cluster. H4 reads S x 1024
// counts once: at the paths' 16 and 1024 groups a warp's chain (its loads,
// two scans, a lower bound, a table read) sets its time over the launch, at
// 4096 groups the 33.5 MB read.
//
// Integer sums are unsigned 64-bit wrapping adds, so they are exact mod 2^64
// like the reference's reconstruct_i64. H2's f64 adds and products round on
// their own (__dadd_rn, __dmul_rn); lanes (b) and (c) add in a
// non-deterministic order; PERF.md states the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <mutex>
#include <vector>

#include "common.cuh"
#include "rows.cuh"

namespace {

using px::allow_smem;
using px::grid_for;
using px::kThreads;

// ---------------------------------------------------------------- H1
// The rows of one launch, each read where the fold staged it (rows.cuh):
// ``RV`` value rows (a typed pointer, an offset added once a row, the
// output row it sums into), ``presence`` the output rows that are the
// count itself (count's row: no bytes read), the count at ``count_row``.
constexpr int kMaxRows = 32;

struct RowArgs {
  const void* ptr[kMaxRows];
  long long off[kMaxRows];
  int kind[kMaxRows];
  int out_row[kMaxRows];
  unsigned int vec_row;  // bit r: value row r takes vector loads
  unsigned int presence;
  int RV;
  int count_row;
  int vec;  // gids and mask take vector loads
  const int* gids;
  const unsigned char* mask;
  long long n;
  int S;
  unsigned long long* out;
};

// Adds a group's count (cnt rows) into the count row and every presence
// row of the output.
__device__ __forceinline__ void add_count(const RowArgs& a, int g, unsigned long long cnt) {
  const long long S = a.S;
  atomicAdd(&a.out[(long long)a.count_row * S + g], cnt);
  for (unsigned int p = a.presence; p != 0u; p &= p - 1u) {
    atomicAdd(&a.out[(long long)(__ffs(p) - 1) * S + g], cnt);
  }
}

// Adds value row r's sum of cnt rows of group g with the row's offset:
// sum(v + off) = sum(v) + cnt * off (mod 2^64).
__device__ __forceinline__ void add_value(const RowArgs& a, int r, int g,
                                          unsigned long long sum, unsigned long long cnt) {
  const unsigned long long x = sum + cnt * (unsigned long long)a.off[r];
  if (x != 0ull) atomicAdd(&a.out[(long long)a.out_row[r] * a.S + g], x);
}

// A 64-bit warp shuffle as two 32-bit ones.
__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long v, int w) {
  const unsigned int lo = __shfl_xor_sync(0xFFFFFFFFu, (unsigned int)v, w);
  const unsigned int hi = __shfl_xor_sync(0xFFFFFFFFu, (unsigned int)(v >> 32), w);
  return ((unsigned long long)hi << 32) | lo;
}

// A 64-bit add into two 32-bit words of shared memory by native 32-bit
// atomics (a 64-bit shared atomic add is a compare-and-swap loop): the low
// word's add returns its old value, and a wrap carries into the high word.
__device__ __forceinline__ void add_u64_split(unsigned int* lo, unsigned int* hi,
                                              unsigned long long v) {
  const unsigned int vlo = (unsigned int)v, vhi = (unsigned int)(v >> 32);
  const unsigned int old = atomicAdd(lo, vlo);
  const unsigned int carry = old + vlo < old ? 1u : 0u;
  if (vhi + carry != 0u) atomicAdd(hi, vhi + carry);
}

// (a) S <= SB <= 32: a count and RV sums a cell for each thread, private,
// in shared memory laid out [cell][thread] (a thread's cells in distinct
// banks: no conflicts, no atomics), 8 rows a thread a step; then the CTA
// adds each cell's kRegsThreads entries by warps and flushes them: one
// global atomic per CTA and cell, kRegsCtasPerSm CTAs an SM. Up to two
// value rows a launch (the host launches again for more, the first launch
// adds the count and presence).
constexpr int kRegsThreads = 256;
constexpr int kRegsCtasPerSm = 2;

template <int SB, int RV>
__global__ void __launch_bounds__(kRegsThreads)
    rows_sum_regs_kernel(const RowArgs a, int first) {
  constexpr int RVA = RV > 0 ? RV : 1;
  extern __shared__ unsigned long long sh_priv[];
  unsigned long long* val = sh_priv;  // [RV][SB][threads]
  unsigned int* cnt = reinterpret_cast<unsigned int*>(sh_priv + RV * SB * kRegsThreads);
  __shared__ unsigned long long sh_tot[RVA + 1][SB];  // the CTA's cells; row RV: counts
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    cnt[s * kRegsThreads + t] = 0u;
#pragma unroll
    for (int r = 0; r < RV; ++r) val[(r * SB + s) * kRegsThreads + t] = 0ull;
  }
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + t; c < chunks; c += stride) {
    const long long i0 = c * px::kRowsPerThread;
    int g[px::kRowsPerThread];
    px::load_gids8(a.gids, a.mask, i0, a.n, a.S, a.vec != 0, g);
    unsigned long long v[RVA][px::kRowsPerThread];
#pragma unroll
    for (int r = 0; r < RV; ++r) {
      px::load_vals8(a.ptr[r], a.kind[r], i0, a.n, (a.vec_row >> r) & 1u, v[r]);
    }
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (g[j] < 0) continue;
      cnt[g[j] * kRegsThreads + t] += 1u;
#pragma unroll
      for (int r = 0; r < RV; ++r) val[(r * SB + g[j]) * kRegsThreads + t] += v[r][j];
    }
  }
  __syncthreads();
  // Cell x of the CTA (x < SB: a count; then row r's sums) by one warp.
  const int lane = t & 31, warp = t / 32, warps = kRegsThreads / 32;
  for (int x = warp; x < (RV + 1) * SB; x += warps) {
    unsigned long long sum = 0ull;
    if (x < SB) {
      for (int k = lane; k < kRegsThreads; k += 32) sum += cnt[x * kRegsThreads + k];
    } else {
      for (int k = lane; k < kRegsThreads; k += 32) sum += val[(x - SB) * kRegsThreads + k];
    }
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) sum += shfl_xor(sum, w);
    if (lane == 0) {
      if (x < SB) sh_tot[RV][x] = sum;
      else sh_tot[(x - SB) / SB][(x - SB) % SB] = sum;
    }
  }
  __syncthreads();
  for (int s = t; s < SB && s < a.S; s += blockDim.x) {
    const unsigned long long cnt = sh_tot[RV][s];
    if (cnt == 0ull) continue;
    if (first) add_count(a, s, cnt);
#pragma unroll
    for (int r = 0; r < RV; ++r) add_value(a, r, s, sh_tot[r][s], cnt);
  }
}

// (b) the partial [RV + 1, S] in each CTA's shared memory (the value rows'
// sums as low and high 32-bit words, add_u64_split, then a u32 count),
// while it fits: every row adds into its own CTA's partial by native
// 32-bit shared atomics. Then a thread block cluster adds its CTAs' partials
// through distributed shared memory, each rank the groups of its slice
// [r * slice, (r + 1) * slice), and flushes them: a cell takes one global
// atomic per cluster, not one per CTA.
constexpr int kCluster = 8;  // CTAs of a cluster (ops/kernels/__init__.py H1_CLUSTER)

__global__ void __launch_bounds__(px::kThreads)
    rows_sum_cluster_kernel(const RowArgs a) {
  constexpr int C = kCluster;
  namespace cg = cooperative_groups;
  extern __shared__ unsigned long long sh_u64[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.S;
  // [RV][S] sums as low and high words ([RV][2][S] u32), then [S] counts.
  unsigned int* vals = reinterpret_cast<unsigned int*>(sh_u64);
  unsigned int* cnts = vals + 2ll * a.RV * S;
  for (long long c = threadIdx.x; c < (2ll * a.RV + 1) * S; c += blockDim.x) vals[c] = 0u;
  __syncthreads();
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const long long i0 = c * px::kRowsPerThread;
    int g[px::kRowsPerThread];
    px::load_gids8(a.gids, a.mask, i0, a.n, S, a.vec != 0, g);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (g[j] >= 0) atomicAdd(&cnts[g[j]], 1u);
    }
    for (int r = 0; r < a.RV; ++r) {
      unsigned long long v[px::kRowsPerThread];
      px::load_vals8(a.ptr[r], a.kind[r], i0, a.n, (a.vec_row >> r) & 1u, v);
#pragma unroll
      for (int j = 0; j < px::kRowsPerThread; ++j) {
        if (g[j] >= 0 && v[j] != 0ull) {
          unsigned int* lo = vals + 2ll * r * S + g[j];
          add_u64_split(lo, lo + S, v[j]);
        }
      }
    }
  }
  cluster.sync();  // every CTA's partial is complete
  const int slice = (S + C - 1) / C;
  const int lo = (int)cluster.block_rank() * slice;
  const int hi = min(S, lo + slice);
  for (int g = lo + threadIdx.x; g < hi; g += blockDim.x) {
    unsigned long long cnt = 0ull;
#pragma unroll
    for (int q = 0; q < C; ++q) cnt += *cluster.map_shared_rank(&cnts[g], q);
    if (cnt == 0ull) continue;
    add_count(a, g, cnt);
    for (int r = 0; r < a.RV; ++r) {
      unsigned long long s = 0ull;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const unsigned int* w = cluster.map_shared_rank(vals + 2ll * r * S + g, q);
        s += ((unsigned long long)w[S] << 32) | w[0];
      }
      add_value(a, r, g, s, cnt);
    }
  }
  cluster.sync();  // no CTA leaves while others read its partial
}

// (c) any S: every row straight into the output by global atomics, each
// value with its offset.
__global__ void __launch_bounds__(px::kThreads) rows_sum_global_kernel(const RowArgs a) {
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const long long i0 = c * px::kRowsPerThread;
    int g[px::kRowsPerThread];
    px::load_gids8(a.gids, a.mask, i0, a.n, a.S, a.vec != 0, g);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (g[j] >= 0) add_count(a, g[j], 1ull);
    }
    for (int r = 0; r < a.RV; ++r) {
      unsigned long long v[px::kRowsPerThread];
      px::load_vals8(a.ptr[r], a.kind[r], i0, a.n, (a.vec_row >> r) & 1u, v);
#pragma unroll
      for (int j = 0; j < px::kRowsPerThread; ++j) {
        if (g[j] >= 0) add_value(a, r, g[j], v[j], 1ull);
      }
    }
  }
}

// ---------------------------------------------------------------- H2
// The rows of one launch: ``R`` value rows (a typed pointer, the offset of a
// narrowed integer row, whether the row sums its values' squares), the
// gids and mask they share, the [R, S] output; the warp lane's [grid, R, S]
// partials and its ticket (0 between launches).
constexpr int kF64MaxRows = 32;  // rows a launch (ops/kernels/__init__.py H2_MAX_ROWS)
constexpr int kF64WarpRows = 4;  // rows a launch of the warp lane (H2_WARP_ROWS)
constexpr int kF64WarpMaxS = 64;  // the warp lane's largest S (H2_WARP_MAX_S)
constexpr int kF64Threads = 512;

struct F64Args {
  const void* ptr[kF64MaxRows];
  long long off[kF64MaxRows];
  int kind[kF64MaxRows];
  unsigned int square;     // bit r: row r sums its values' squares
  unsigned int vec_row;    // bit r: row r takes vector loads
  unsigned int same_prev;  // bit r: row r reads row r - 1's column (pointer, kind, offset)
  int R;
  int vec;  // gids and mask take vector loads
  const int* gids;
  const unsigned char* mask;
  long long n;
  int S;
  double* out;
  double* partials;
  unsigned int* ticket;
};

// Row r's value of a raw 64-bit load: an f64 as it is, an integer (plus its
// offset, wrapping) rounded to the nearest double; squared on its own
// (__dmul_rn: nvcc contracts nothing into an FMA with the add after it).
__device__ __forceinline__ double f64_value(const F64Args& a, int r, unsigned long long raw) {
  const double x = a.kind[r] == px::kF64
                       ? __longlong_as_double((long long)raw)
                       : __ll2double_rn((long long)(raw + (unsigned long long)a.off[r]));
  return ((a.square >> r) & 1u) ? __dmul_rn(x, x) : x;
}

// Rows j of a thread's 8 whose gid equals row j + 1's carry their sum on:
// x[j + 1] += x[j], and row j leaves (g[j] = -1). What is left is one row a
// run of equal gids, its run's sum in x (in row order).
template <int R>
__device__ __forceinline__ void merge_runs(int (&g)[px::kRowsPerThread],
                                           double (&x)[R][px::kRowsPerThread]) {
#pragma unroll
  for (int j = 0; j + 1 < px::kRowsPerThread; ++j) {
    if (g[j] >= 0 && g[j] == g[j + 1]) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r][j + 1] = __dadd_rn(x[r][j], x[r][j + 1]);
      g[j] = -1;
    }
  }
}

// After each CTA wrote its [cells] partial (a.partials[blockIdx.x]): the
// last CTA to take a ticket adds every CTA's partial into a.out, k threads
// a cell each adding every k-th partial in CTA order (eight loads in
// flight), then the cell's thread their k sums in order; it sets the
// ticket back to 0. ``scratch``: blockDim doubles of shared memory.
__device__ void finish_partials(const F64Args& a, int cells, double* scratch) {
  __shared__ bool sh_last;
  // One fence a CTA, by the thread that takes the ticket after the barrier
  // (cumulative: it orders the CTA's partial before the ticket).
  __syncthreads();
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
    for (int b = t / cells; b < grid; b += 8 * k) {
      double v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int bq = b + q * k;
        v[q] = bq < grid ? __ldcg(&a.partials[(long long)bq * cells + c]) : 0.0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) sum = __dadd_rn(sum, v[q]);
    }
    scratch[t] = sum;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    double sum = 0.0;
    for (int p = 0; p < k; ++p) sum = __dadd_rn(sum, scratch[p * cells + c]);
    a.out[c] = sum;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// (a1) R * SB <= 64 cells (SB: S rounded up to 8, 16, 32 or 64): each
// thread's cells private in shared memory, laid out [cell][thread] (a
// thread's cells in distinct banks: no conflicts, no atomics), its rows
// added in row order; then each cell's threads added by a warp in a fixed
// order into the CTA's partial, and the partials as the warp lane adds
// them (finish_partials). Two CTAs an SM up to 48 cells, one above.
constexpr int kF64PrivThreads = 256;

template <int R, int SB>
__global__ void __launch_bounds__(kF64PrivThreads, 2) rows_f64_private_kernel(const F64Args a) {
  constexpr int J = px::kRowsPerThread, T = kF64PrivThreads, CELLS = R * SB;
  extern __shared__ double sh_priv_f64[];  // [CELLS][T], then the tail's scratch
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = T / 32;
  const int S = a.S;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) sh_priv_f64[c * T + t] = 0.0;
  const long long chunks = (a.n + J - 1) / J;
  const long long stride = (long long)gridDim.x * T;
  for (long long ch = (long long)blockIdx.x * T + t; ch < chunks; ch += stride) {
    const long long i0 = ch * J;
    int g[J];
    px::load_gids8(a.gids, a.mask, i0, a.n, S, a.vec != 0, g);
    unsigned long long raw[J];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r == 0 || !((a.same_prev >> r) & 1u)) {
        px::load_vals8(a.ptr[r], a.kind[r], i0, a.n, (a.vec_row >> r) & 1u, raw);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (g[j] >= 0) {
          double* cell = &sh_priv_f64[(r * SB + g[j]) * T + t];
          *cell = __dadd_rn(*cell, f64_value(a, r, raw[j]));
        }
      }
    }
  }
  __syncthreads();
  // Cell c (row c / SB, group c % SB) of the CTA by warp c % warps: each
  // lane adds its 8 threads in order, then a fixed shuffle tree.
  for (int c = warp; c < CELLS; c += warps) {
    double sum = 0.0;
#pragma unroll
    for (int q = 0; q < T / 32; ++q) sum = __dadd_rn(sum, sh_priv_f64[c * T + q * 32 + lane]);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) sum = __dadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, w));
    const int r = c / SB, s = c % SB;
    if (lane == 0 && s < S) __stcg(&a.partials[((long long)blockIdx.x * R + r) * S + s], sum);
  }
  finish_partials(a, R * S, sh_priv_f64 + CELLS * T);
}

// (a2) S <= kF64WarpMaxS, more cells than (a1) takes: no f64 atomics. A
// thread merges its 8 rows' runs
// of equal gids in registers. Then, for each of its 8 rows at once (8
// independent chains), the warp finds the lanes that hold the same gid
// (a ballot of each of the gid's bits) and adds their
// sums in a fixed tree (each round a lane adds the next peer still in
// play, and every second peer leaves), so the lowest lane of each gid holds
// its sum and adds it into the warp's own [R, S] cells in shared memory.
// The CTA adds its warps in order into its [R, S] partial in global
// scratch; the last CTA to finish (a ticket) adds the partials in a fixed
// order and writes the output. The same inputs give the same bits on every
// run.
template <int R>
__global__ void __launch_bounds__(kF64Threads, 1) rows_f64_warp_kernel(const F64Args a) {
  constexpr int J = px::kRowsPerThread;
  extern __shared__ double sh_warp[];  // [warps][R][S]
  const int S = a.S, cells = R * S;
  const int nb = S > 1 ? 32 - __clz(S - 1) : 0;  // bits of a gid
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  for (int c = threadIdx.x; c < warps * cells; c += blockDim.x) sh_warp[c] = 0.0;
  __syncthreads();
  double* mine = sh_warp + warp * cells;
  const long long chunks = (a.n + J - 1) / J;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // Every lane of a warp runs the same trips (the shuffles need them all).
  for (long long c0 = (long long)blockIdx.x * blockDim.x + warp * 32; c0 < chunks; c0 += stride) {
    const long long i0 = (c0 + lane) * J;
    int g[J];
    px::load_gids8(a.gids, a.mask, i0, a.n, S, a.vec != 0, g);
    double x[R][J];
    unsigned long long raw[J];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // A row over the column before's (its value, then its square) reads
      // nothing again.
      if (r == 0 || !((a.same_prev >> r) & 1u)) {
        px::load_vals8(a.ptr[r], a.kind[r], i0, a.n, (a.vec_row >> r) & 1u, raw);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) x[r][j] = f64_value(a, r, raw[j]);
    }
    merge_runs<R>(g, x);
    unsigned int rest[J], lead = 0u;  // lead: bit j, this lane adds row j's gid
    int rank[J];
    int most = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      unsigned int p = __ballot_sync(0xFFFFFFFFu, g[j] >= 0);
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        if (b < nb) {
          const bool bit = (g[j] >> b) & 1;
          const unsigned int m = __ballot_sync(0xFFFFFFFFu, bit);
          p &= bit ? m : ~m;
        }
      }
      if (g[j] < 0) p = 0u;
      rank[j] = __popc(p & below);
      rest[j] = p & (0xFFFFFFFEu << lane);
      if (g[j] >= 0 && rank[j] == 0) lead |= 1u << j;
      most = max(most, __popc(p));
    }
    most = (int)__reduce_max_sync(0xFFFFFFFFu, (unsigned int)most);
    for (int span = 1; span < most; span <<= 1) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int next = __ffs(rest[j]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const double t = __shfl_sync(0xFFFFFFFFu, x[r][j], (next - 1) & 31);
          if (next) x[r][j] = __dadd_rn(x[r][j], t);
        }
        rest[j] &= __ballot_sync(0xFFFFFFFFu, (rank[j] & 1) == 0);
        rank[j] >>= 1;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if ((lead >> j) & 1u) {
#pragma unroll
        for (int r = 0; r < R; ++r) mine[r * S + g[j]] = __dadd_rn(mine[r * S + g[j]], x[r][j]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    double t = 0.0;
    for (int w = 0; w < warps; ++w) t = __dadd_rn(t, sh_warp[w * cells + c]);
    __stcg(&a.partials[(long long)blockIdx.x * cells + c], t);
  }
  finish_partials(a, cells, sh_warp);
}

// (b) a larger S whose [R, S] partial fits a CTA's shared memory: the rows'
// runs merged in registers, then one shared f64 atomic a run and cell (a
// compare-and-swap loop on sm_90a: ATOMS.CAST.SPIN.64), one global atomic a
// CTA and cell at the flush; (c) one global atomic a run and cell (the
// L2's native f64 add) into the output, zeroed by the caller.
__global__ void __launch_bounds__(px::kThreads) rows_f64_atomic_kernel(const F64Args a,
                                                                       int use_shared) {
  extern __shared__ double sh_acc[];
  const int S = a.S;
  const long long cells = (long long)a.R * S;
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) sh_acc[c] = 0.0;
    __syncthreads();
  }
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const long long i0 = c * px::kRowsPerThread;
    int g[px::kRowsPerThread];
    px::load_gids8(a.gids, a.mask, i0, a.n, S, a.vec != 0, g);
    for (int r = 0; r < a.R; ++r) {
      unsigned long long raw[px::kRowsPerThread];
      px::load_vals8(a.ptr[r], a.kind[r], i0, a.n, (a.vec_row >> r) & 1u, raw);
      double run = 0.0;
#pragma unroll
      for (int j = 0; j < px::kRowsPerThread; ++j) {
        if (g[j] < 0) continue;
        run = __dadd_rn(run, f64_value(a, r, raw[j]));
        if (j + 1 == px::kRowsPerThread || g[j + 1] != g[j]) {
          // One address space a branch: a shared f64 add is a CAS loop, a
          // global one the L2's native add.
          if (use_shared) atomicAdd(&sh_acc[(long long)r * S + g[j]], run);
          else atomicAdd(&a.out[(long long)r * S + g[j]], run);
          run = 0.0;
        }
      }
    }
  }
  if (use_shared) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      const double v = sh_acc[c];
      if (v != 0.0) atomicAdd(&a.out[c], v);  // NaN too
    }
  }
}

constexpr int kF64PrivMaxCells = 64;  // ops/kernels/__init__.py H2_PRIVATE_CELLS

template <int R, int SB>
cudaError_t launch_f64_private(const F64Args& a, int grid, cudaStream_t st) {
  const size_t smem = (size_t)(R * SB + 1) * kF64PrivThreads * sizeof(double);
  cudaError_t err = allow_smem(rows_f64_private_kernel<R, SB>, smem);
  if (err != cudaSuccess) return err;
  rows_f64_private_kernel<R, SB><<<grid, kF64PrivThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int SB>
cudaError_t launch_f64_private_sb(const F64Args& a, int grid, cudaStream_t st) {
  switch (a.R) {
    case 1: return launch_f64_private<1, SB>(a, grid, st);
    case 2: return SB <= 32 ? launch_f64_private<2, (SB <= 32 ? SB : 32)>(a, grid, st)
                            : cudaErrorInvalidValue;
    case 3: return SB <= 16 ? launch_f64_private<3, (SB <= 16 ? SB : 16)>(a, grid, st)
                            : cudaErrorInvalidValue;
    case 4: return SB <= 16 ? launch_f64_private<4, (SB <= 16 ? SB : 16)>(a, grid, st)
                            : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <int R>
cudaError_t launch_f64_warps(const F64Args& a, int grid, cudaStream_t st) {
  // The warps' cells, and room for the last CTA's k sums a cell.
  const int cells = (kF64Threads / 32) * R * a.S;
  const size_t smem = (size_t)(cells > kF64Threads ? cells : kF64Threads) * sizeof(double);
  rows_f64_warp_kernel<R><<<grid, kF64Threads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- H3
// bin_index exactly as pixie_tpu/ops/histogram.py:49-56 writes it, in f32:
// max(v, min) (NaN propagates, as jnp.maximum does), log(v / min) / log(gamma)
// with the accurate logf (no fast-math), floor, +1, v <= min -> 0, clip.
// unit_min (min 1): v / min is v exactly, so the division is left out.
__device__ __forceinline__ int log_bin(float vf, float min_value, float log_gamma, int nbins,
                                       bool unit_min) {
  const float v = (vf != vf) ? vf : fmaxf(vf, min_value);
  const float x = floorf(logf(unit_min ? v : v / min_value) / log_gamma);
  // cvt.rzi.s32.f32 saturates and maps NaN to 0, as XLA's convert does;
  // the +1 wraps like the reference's int32 add.
  int idx = (int)((unsigned int)__float2int_rz(x) + 1u);
  if (vf <= min_value) idx = 0;
  return min(max(idx, 0), nbins - 1);
}

// H3's rows and lane: the values f32, or f64 rounded to f32 in registers
// (torch's .to(float32)), read where the fold staged them.
struct HistArgs {
  const void* values;
  int f64;
  const int* gids;
  const unsigned char* mask;
  long long n;
  int S, nbins;
  float min_value, log_gamma;
  int unit_min;  // min_value is 1: v / min is v exactly, so log_bin skips the division
  int vec;       // values, gids and mask take vector loads
  int part;      // cells a rank flushes (cluster lane), a multiple of 8
  unsigned long long* state;
  long long* probe;  // null, or int64 [H3_PROBE]: [0] global atomics, [2..5] CTA 0's clocks
};

constexpr int kHistThreads = 1024;  // the cluster lane's CTA: one an SM
constexpr int kHistChunks = 7;      // chunks of 8 rows a thread at most: u16 counts stay exact

__device__ __forceinline__ void hist_clock(const HistArgs& a, int k) {
  if (a.probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) a.probe[k] = clock64();
}

__device__ __forceinline__ float hist_value(const HistArgs& a, long long i) {
  return a.f64 ? __double2float_rn(((const double*)a.values)[i]) : ((const float*)a.values)[i];
}

__device__ __forceinline__ long long hist_cell(const HistArgs& a, int g, float v) {
  return (long long)g * a.nbins + log_bin(v, a.min_value, a.log_gamma, a.nbins, a.unit_min != 0);
}

// The (group, log bin) cell of rows i0 .. i0 + 7, -1 for a row that adds
// nothing.
__device__ __forceinline__ void hist_cells8(const HistArgs& a, long long i0,
                                            long long (&cell)[px::kRowsPerThread]) {
  int g[px::kRowsPerThread];
  px::load_gids8(a.gids, a.mask, i0, a.n, a.S, a.vec != 0, g);
  float v[px::kRowsPerThread];
  if (a.vec && i0 + px::kRowsPerThread <= a.n) {
    if (a.f64) {
      const double2* p = reinterpret_cast<const double2*>((const double*)a.values + i0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const double2 x = __ldcs(p + k);
        v[2 * k] = __double2float_rn(x.x);
        v[2 * k + 1] = __double2float_rn(x.y);
      }
    } else {
      const float4* p = reinterpret_cast<const float4*>((const float*)a.values + i0);
      const float4 x = __ldcs(p), y = __ldcs(p + 1);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      v[j] = i0 + j < a.n ? hist_value(a, i0 + j) : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < px::kRowsPerThread; ++j) cell[j] = g[j] < 0 ? -1 : hist_cell(a, g[j], v[j]);
}

// Adds the CTA's count of global atomics into probe[0].
__device__ __forceinline__ void hist_count_atomics(const HistArgs& a, unsigned long long k) {
  if (a.probe == nullptr) return;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) k += __shfl_xor_sync(0xFFFFFFFFu, k, w);
  if ((threadIdx.x & 31) == 0 && k != 0ull) {
    atomicAdd((unsigned long long*)&a.probe[0], k);
  }
}

// The cluster lane, a cluster of kCluster CTAs, one CTA an SM. Each CTA
// counts its rows into its own [S, nbins] partial of u16 counts, two a
// word, by shared atomics; after the cluster's barrier each rank adds its
// part of the cells across the kCluster partials through distributed
// shared memory (16-byte reads: 8 cells) and issues one global atomic a
// nonzero cell, not one a CTA or a row. A thread takes at most
// kHistChunks chunks of 8 rows (the launch's grid sees to it), so a CTA
// counts at most 57,344 rows and no u16 count carries into its neighbour.
__global__ void __launch_bounds__(kHistThreads) hist_cluster_kernel(const HistArgs a) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned int sh_hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const long long cells = (long long)a.S * a.nbins;
  hist_clock(a, 2);
  for (long long w = threadIdx.x; w < (cells + 7) / 8; w += blockDim.x) {
    reinterpret_cast<uint4*>(sh_hist)[w] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  hist_clock(a, 3);
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x; ch < chunks;
       ch += stride) {
    long long cell[px::kRowsPerThread];
    hist_cells8(a, ch * px::kRowsPerThread, cell);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (cell[j] >= 0) atomicAdd(&sh_hist[cell[j] >> 1], 1u << ((cell[j] & 1) << 4));
    }
  }
  cluster.sync();  // every row is counted
  hist_clock(a, 4);
  const long long lo = (long long)cluster.block_rank() * a.part;
  const long long hi = min(cells, lo + a.part);
  unsigned long long issued = 0ull;
  for (long long c = lo + 8ll * threadIdx.x; c < hi; c += 8ll * blockDim.x) {
    unsigned int k[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      const uint4 x = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(sh_hist + c / 2, q));
      const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k[2 * j] += w[j] & 0xFFFFu;
        k[2 * j + 1] += w[j] >> 16;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (k[j] != 0u && c + j < hi) {
        atomicAdd(&a.state[c + j], (unsigned long long)k[j]);
        ++issued;
      }
    }
  }
  hist_count_atomics(a, issued);
  cluster.sync();  // no CTA leaves while others read its partial
  hist_clock(a, 5);
}

// (b) any S: every row straight into the state by a global atomic, a row a
// thread a step (more rows a thread in flight lost to the L2's same-cell
// atomics at S = 64).
__global__ void __launch_bounds__(px::kThreads) hist_global_kernel(const HistArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned long long issued = 0ull;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    if (a.mask != nullptr && !a.mask[i]) continue;
    const int g = a.gids[i];
    if (g < 0 || g >= a.S) continue;
    atomicAdd(&a.state[hist_cell(a, g, hist_value(a, i))], 1ull);
    ++issued;
  }
  hist_count_atomics(a, issued);
}

// ---------------------------------------------------------------- H4
// A warp a group, no barrier; as many groups a CTA as there are groups for
// each SM, up to 4 (``hq_warps``), so that a few groups spread over as many
// SMs. A lane holds 32 consecutive bins of a chunk of 1024 (at nbins = 1024
// the whole row). The warp reads the chunk coalesced (16 loads of 16 bytes a
// lane, all issued before any is used: a lane's own 256 bytes read straight
// would touch 32 lines an instruction) and hands each lane its bins through
// its 8.5 KB of shared memory, rows padded so that neither side conflicts. A
// lane adds its bins in int64, and a five-round shuffle scan gives it the
// counts before its bins and the group's total. Each cumulative count is
// converted to f64 once: below 2^53 these and the total are the reference's
// f64 sums exactly. The first bin whose count reaches a target is the first
// whose running maximum of the counts so far does (``key``, non-decreasing
// along the bins; the counts themselves where none is negative), so each q
// is a lower bound over sorted keys, and every lane searches its own q at
// once: five shuffle steps find the lane, the 32 keys of that lane the bin.
// The target is max(q * total, 1e-9) in f64, as the reference computes it;
// a q that no bin reaches takes bin 0 (the reference's argmax over an
// all-false row). The value is the bin's geometric midpoint from ``mid``, a
// table the wrapper builds with the plain version's own expression on the
// same device, so the kernel computes no pow and returns the plain version's
// bits; an empty group gives 0. A row wider than a chunk is summed in one
// pass, then searched chunk by chunk (reloaded from the L1) until every q of
// a block of 32 has its bin.
constexpr unsigned int kHqAll = 0xFFFFFFFFu;
constexpr int kHqMaxWarps = 4;   // groups a CTA at most: a warp a group
constexpr int kHqLaneBins = 32;  // consecutive bins a lane
constexpr int kHqChunk = 32 * kHqLaneBins;
constexpr int kHqRow = kHqLaneBins + 2;  // a lane's row of shared memory, in int64

// Groups a CTA: about one a warp on every SM, 1 to kHqMaxWarps.
inline int hq_warps(int S) {
  const int sms = px::num_sms();
  return max(1, min(kHqMaxWarps, (S + sms - 1) / sms));
}

// A lane's bins of the chunk starting at bin c0 (0 past nbins), read
// coalesced into the warp's rows ``sh`` and back; ``vec``: the row is
// 16-byte aligned and nbins even.
__device__ __forceinline__ void hq_load(const long long* __restrict__ row, int nbins, bool vec,
                                        int c0, int lane, long long* __restrict__ sh,
                                        long long (&b)[kHqLaneBins]) {
  if (vec) {  // load i: bins c0 + 64 i + 2 lane and the next, row 2 i + lane / 16
    longlong2 v[kHqLaneBins / 2];
#pragma unroll
    for (int i = 0; i < kHqLaneBins / 2; ++i) {
      const int bin = c0 + 64 * i + 2 * lane;
      v[i] = bin < nbins ? __ldg(reinterpret_cast<const longlong2*>(row + bin))
                         : make_longlong2(0ll, 0ll);
    }
#pragma unroll
    for (int i = 0; i < kHqLaneBins / 2; ++i) {
      *reinterpret_cast<longlong2*>(sh + (2 * i + (lane >> 4)) * kHqRow + ((2 * lane) & 31)) =
          v[i];
    }
  } else {  // load i: bin c0 + 32 i + lane, row i
    long long v[kHqLaneBins];
#pragma unroll
    for (int i = 0; i < kHqLaneBins; ++i) {
      const int bin = c0 + 32 * i + lane;
      v[i] = bin < nbins ? row[bin] : 0ll;
    }
#pragma unroll
    for (int i = 0; i < kHqLaneBins; ++i) sh[i * kHqRow + lane] = v[i];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kHqLaneBins / 2; ++k) {
    const longlong2 x = *reinterpret_cast<const longlong2*>(sh + lane * kHqRow + 2 * k);
    b[2 * k] = x.x;
    b[2 * k + 1] = x.y;
  }
  __syncwarp();  // the rows are free for the next chunk
}

// The running maximum of the cumulative counts (f64) through each of the
// lane's bins into ``key``, from ``carry`` (the counts of the chunks before)
// and ``kcarry`` (their keys' maximum); returns the chunk's total. Where no
// count of the chunk is negative the cumulative counts are their own
// running maximum.
__device__ __forceinline__ long long hq_keys(const long long (&b)[kHqLaneBins], long long carry,
                                             double kcarry, int lane,
                                             double (&key)[kHqLaneBins]) {
  long long s = 0;
  bool down = false;
#pragma unroll
  for (int k = 0; k < kHqLaneBins; ++k) {
    s += b[k];
    down = down || b[k] < 0;
  }
  long long incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long t = __shfl_up_sync(kHqAll, incl, d);
    if (lane >= d) incl += t;
  }
  long long run = carry + incl - s;
#pragma unroll
  for (int k = 0; k < kHqLaneBins; ++k) {
    run += b[k];
    key[k] = (double)run;
  }
  if (__any_sync(kHqAll, down)) {
    double mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kHqLaneBins; ++k) {
      mx = fmax(mx, key[k]);
      key[k] = mx;
    }
    double before = __shfl_up_sync(kHqAll, mx, 1);  // the lanes before's maximum
    before = lane == 0 ? kcarry : fmax(before, kcarry);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(kHqAll, before, d);
      if (lane >= d) before = fmax(before, t);
    }
    kcarry = before;
  }
#pragma unroll
  for (int k = 0; k < kHqLaneBins; ++k) key[k] = fmax(key[k], kcarry);
  return __shfl_sync(kHqAll, incl, 31);
}

// CTA 0's first lane stamps clock64 into probe[k] (if given): 0 at the
// start, 1 with the total, 2 after the searches, 3 after the stores.
__device__ __forceinline__ void hq_clock(long long* probe, int k) {
  if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) probe[k] = clock64();
}

template <bool kOne>  // kOne: the row is one chunk, loaded once
__device__ __forceinline__ void hq_group(const long long* __restrict__ row, int nbins, bool vec,
                                         const double* __restrict__ qs, int Q,
                                         const double* __restrict__ mid,
                                         double* __restrict__ out, int lane,
                                         long long* __restrict__ sh, long long* probe) {
  const int nch = kOne ? 1 : (nbins + kHqChunk - 1) / kHqChunk;
  long long b[kHqLaneBins];
  double key[kHqLaneBins];
  long long total = 0;
  if (kOne) {
    hq_load(row, nbins, vec, 0, lane, sh, b);
    total = hq_keys(b, 0, -INFINITY, lane, key);
  } else {
    for (int c = 0; c < nch; ++c) {  // the lane's sums, then one warp sum
      hq_load(row, nbins, vec, c * kHqChunk, lane, sh, b);
#pragma unroll
      for (int k = 0; k < kHqLaneBins; ++k) total += b[k];
    }
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) total += __shfl_xor_sync(kHqAll, total, w);
  }
  hq_clock(probe, 1);
  const double dtotal = (double)total;
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int nq = min(Q - q0, 32);
    // lane j searches the block's j-th q
    const double target = fmax((lane < nq ? qs[q0 + lane] : 0.0) * dtotal, 1e-9);
    int bin = 0;
    bool found = false;
    long long carry = 0;
    double kcarry = -INFINITY;
    for (int c = 0; c < nch && __any_sync(kHqAll, lane < nq && !found); ++c) {
      if (!kOne) {
        hq_load(row, nbins, vec, c * kHqChunk, lane, sh, b);
        carry += hq_keys(b, carry, kcarry, lane, key);
      }
      kcarry = __shfl_sync(kHqAll, key[kHqLaneBins - 1], 31);  // the chunk's largest key
      int pos = 0;  // the first lane whose last key reaches the target
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        pos += __shfl_sync(kHqAll, key[kHqLaneBins - 1], pos + d - 1) < target ? d : 0;
      }
      int slot = 0;  // its keys below the target
#pragma unroll
      for (int k = 0; k < kHqLaneBins; ++k) slot += __shfl_sync(kHqAll, key[k], pos) < target;
      const bool now = !found && kcarry >= target;
      bin = now ? c * kHqChunk + pos * kHqLaneBins + slot : bin;
      found = found || now;
    }
    hq_clock(probe, 2);
    if (lane < nq) out[q0 + lane] = total > 0 ? mid[bin] : 0.0;
  }
  hq_clock(probe, 3);
}

__global__ void __launch_bounds__(kHqMaxWarps * 32)
    hist_quantiles_kernel(const long long* __restrict__ state, int S, int nbins, int vec,
                          const double* __restrict__ qs, int Q, const double* __restrict__ mid,
                          double* __restrict__ out, long long* __restrict__ probe) {
  __shared__ __align__(16) long long rows[kHqMaxWarps][32 * kHqRow];
  hq_clock(probe, 0);
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= S) return;  // a whole warp
  const long long* row = state + g * nbins;
  long long* sh = rows[threadIdx.x >> 5];
  if (nbins <= kHqChunk) {
    hq_group<true>(row, nbins, vec != 0, qs, Q, mid, out + g * Q, lane, sh, probe);
  } else {
    hq_group<false>(row, nbins, vec != 0, qs, Q, mid, out + g * Q, lane, sh, probe);
  }
}

// Clusters of a kernel at a shared size that fit the card at once, by
// device, found once: the attribute calls and the occupancy query cost the
// host more than a small launch.
struct ClusterFit {
  int device;
  const void* fn;
  size_t smem;
  int clusters;
};
std::mutex g_fit_lock;
std::vector<ClusterFit> g_fits;

// A launch of ``kernel`` in clusters of kCluster CTAs of ``threads`` with
// ``smem`` bytes each: one wave of as many clusters as fit the card at
// once, at most ``cap`` CTAs and no more than ``want`` CTAs round up to,
// but at least ``least`` rounded up (then in more waves). Fills ``cfg``
// (its stream 0) and ``attr``, the cluster attribute it points to.
template <typename Args>
cudaError_t cluster_config(void (*kernel)(Args), size_t smem, int threads, long long want,
                           long long cap, long long least, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  {
    std::lock_guard<std::mutex> hold(g_fit_lock);
    for (const ClusterFit& f : g_fits) {
      if (f.device == dev && f.fn == (const void*)kernel && f.smem == smem) clusters = f.clusters;
    }
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(kCluster);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  if (clusters == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    std::lock_guard<std::mutex> hold(g_fit_lock);
    g_fits.push_back({dev, (const void*)kernel, smem, clusters});
  }
  long long ctas = (long long)clusters * kCluster;
  if (ctas > cap) ctas = cap / kCluster * kCluster;
  const long long need = (want + kCluster - 1) / kCluster * kCluster;
  if (need < ctas) ctas = need;
  if (ctas < least) ctas = (least + kCluster - 1) / kCluster * kCluster;
  if (ctas < kCluster) ctas = kCluster;
  cfg->gridDim = dim3((unsigned)ctas);
  return cudaSuccess;
}

// The cluster lane's launch: one wave of clusters, no more CTAs than
// ``want`` rounds up to.
cudaError_t launch_cluster_lane(const RowArgs& a, size_t smem, long long want,
                                cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(rows_sum_cluster_kernel, smem, px::kThreads, want, 1ll << 40,
                                   0, attr, &cfg);
  if (err != cudaSuccess) return err;
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, rows_sum_cluster_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The register lane's launch: kRegsCtasPerSm CTAs an SM at most.
template <int SB, int RV>
cudaError_t launch_regs_rv(const RowArgs& a, int first, cudaStream_t st) {
  const long long want = ((a.n + 7) / 8 + kRegsThreads - 1) / kRegsThreads;
  long long grid = (long long)px::num_sms() * kRegsCtasPerSm;
  if (want < grid) grid = want > 0 ? want : 1;
  const size_t smem = (size_t)SB * kRegsThreads * (4 + 8 * RV);
  // The private cells with the static totals may pass 48 KB at smem < 48 KB.
  cudaError_t err = cudaFuncSetAttribute(rows_sum_regs_kernel<SB, RV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rows_sum_regs_kernel<SB, RV><<<(int)grid, kRegsThreads, smem, st>>>(a, first);
  return cudaGetLastError();
}

template <int SB>
cudaError_t launch_regs(const RowArgs& a, int first, cudaStream_t st) {
  switch (a.RV) {
    case 0: return launch_regs_rv<SB, 0>(a, first, st);
    case 1: return launch_regs_rv<SB, 1>(a, first, st);
    case 2: return launch_regs_rv<SB, 2>(a, first, st);
    default: return cudaErrorInvalidValue;
  }
}

// An empty kernel on ``grid`` CTAs of ``threads`` with ``smem`` bytes of
// dynamic shared memory: the floor under a launch of that shape (timed
// beside H3 and H8; it replaces no TPU kernel and no path calls it).
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on this device.
int px_smem_optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// H1. ptrs, kinds, offs: R rows (kinds: rows.cuh RowKind, a kPresence
// row's pointer unread; offs added to each of the row's values). out:
// int64 [R + 1, S], zeroed by the caller, the count last. lane 0: the
// register lane (S <= 32); 1: a cluster of csize CTAs (csize 1: one CTA an
// SM) holding the partial; 2: global atomics (ops/kernels/__init__.py
// h1_lane chooses).
int px_segment_rows_sum_i64(const void* const* ptrs, const int* kinds, const long long* offs,
                            int R, long long n, const void* gids, const void* mask, int S,
                            void* out, int lane, int csize, void* stream) {
  if (R < 0 || R > kMaxRows || S <= 0) return (int)cudaErrorInvalidValue;
  RowArgs a = {};
  a.gids = (const int*)gids;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.S = S;
  a.out = (unsigned long long*)out;
  a.count_row = R;
  a.vec = px::vec_aligned(gids, px::kI32) && (mask == nullptr || (uintptr_t)mask % 8 == 0);
  int rv = 0;
  for (int r = 0; r < R; ++r) {
    if (kinds[r] == px::kPresence) {
      a.presence |= 1u << r;
      continue;
    }
    a.ptr[rv] = ptrs[r];
    a.kind[rv] = kinds[r];
    a.off[rv] = offs[r];
    a.out_row[rv] = r;
    if (px::vec_aligned(ptrs[r], kinds[r])) a.vec_row |= 1u << rv;
    ++rv;
  }
  a.RV = rv;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (lane == 0) {
    if (S > 32) return (int)cudaErrorInvalidValue;
    // Value rows two a launch; the first also adds the count and presence.
    int done = 0;
    do {
      const int take = rv - done < 2 ? rv - done : 2;
      RowArgs part = a;
      part.vec_row = 0u;
      for (int j = 0; j < take; ++j) {
        part.ptr[j] = a.ptr[done + j];
        part.kind[j] = a.kind[done + j];
        part.off[j] = a.off[done + j];
        part.out_row[j] = a.out_row[done + j];
        part.vec_row |= ((a.vec_row >> (done + j)) & 1u) << j;
      }
      part.RV = take;
      const int first = done == 0;
      err = S <= 8 ? launch_regs<8>(part, first, st)
                   : S <= 16 ? launch_regs<16>(part, first, st) : launch_regs<32>(part, first, st);
      if (err != cudaSuccess) return (int)err;
      done += take;
    } while (done < rv);
    return 0;
  }
  if (lane == 1) {
    if (csize != kCluster) return (int)cudaErrorInvalidValue;
    const long long want = ((n + 7) / 8 + px::kThreads - 1) / px::kThreads;
    return (int)launch_cluster_lane(a, (size_t)S * (8 * rv + 4), want, st);
  }
  rows_sum_global_kernel<<<grid_for((n + 7) / 8, 8), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// H2. ptrs, kinds, offs: R value rows (kinds: rows.cuh RowKind but
// kPresence; offs added to an integer row's values); square: bit r, row r
// sums squares. out: f64 [R, S]. lane 0: private cells (R * SB <= 64, R <=
// 4), 1: the warp lane (S <= 64, R <= 4), each over grid CTAs with partials
// f64 [grid, R, S] and ticket (0) its scratch, out written whole; 2: shared
// partials; 3: global atomics, out zeroed by the caller
// (ops/kernels/__init__.py h2_lane chooses).
int px_segment_rows_sum_f64(const void* const* ptrs, const int* kinds, const long long* offs,
                            unsigned int square, int R, long long n, const void* gids,
                            const void* mask, int S, void* out, int lane, int grid,
                            void* partials, void* ticket, void* stream) {
  if (R <= 0 || R > kF64MaxRows || S <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  F64Args a = {};
  a.gids = (const int*)gids;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.S = S;
  a.R = R;
  a.square = square;
  a.out = (double*)out;
  a.partials = (double*)partials;
  a.ticket = (unsigned int*)ticket;
  a.vec = px::vec_aligned(gids, px::kI32) && (mask == nullptr || (uintptr_t)mask % 8 == 0);
  for (int r = 0; r < R; ++r) {
    if (kinds[r] == px::kPresence) return (int)cudaErrorInvalidValue;
    a.ptr[r] = ptrs[r];
    a.kind[r] = kinds[r];
    a.off[r] = offs[r];
    if (px::vec_aligned(ptrs[r], kinds[r])) a.vec_row |= 1u << r;
    if (r > 0 && ptrs[r] == ptrs[r - 1] && kinds[r] == kinds[r - 1] && offs[r] == offs[r - 1]) {
      a.same_prev |= 1u << r;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (lane == 0) {
    const int sb = S <= 8 ? 8 : S <= 16 ? 16 : S <= 32 ? 32 : 64;
    if (S > 64 || R > kF64WarpRows || R * sb > kF64PrivMaxCells || grid <= 0) {
      return (int)cudaErrorInvalidValue;
    }
    switch (sb) {
      case 8: return (int)launch_f64_private_sb<8>(a, grid, st);
      case 16: return (int)launch_f64_private_sb<16>(a, grid, st);
      case 32: return (int)launch_f64_private_sb<32>(a, grid, st);
      default: return (int)launch_f64_private_sb<64>(a, grid, st);
    }
  }
  if (lane == 1) {
    // One row over at most 64 groups always takes (a1).
    if (S > kF64WarpMaxS || R < 2 || R > kF64WarpRows || grid <= 0) {
      return (int)cudaErrorInvalidValue;
    }
    switch (R) {
      case 2: return (int)launch_f64_warps<2>(a, grid, st);
      case 3: return (int)launch_f64_warps<3>(a, grid, st);
      default: return (int)launch_f64_warps<4>(a, grid, st);
    }
  }
  const int use_shared = lane == 2;
  const size_t smem = use_shared ? (size_t)R * S * sizeof(double) : 0;
  cudaError_t err = allow_smem(rows_f64_atomic_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rows_f64_atomic_kernel<<<grid_for((n + 7) / 8, use_shared ? 2 : 8), kThreads, smem, st>>>(
      a, use_shared);
  return (int)cudaGetLastError();
}

// H3's launch over n rows of S groups of nbins bins in ``lane`` (0: the
// cluster lane, each CTA holding the whole [S, nbins] partial of u16
// counts; 1: global atomics; ops/kernels/__init__.py h3_lane chooses):
// ``cfg`` (its stream 0; ``attr`` its cluster attribute on lane 0) and the
// cells a rank flushes.
static cudaError_t hist_config(long long n, int S, int nbins, int lane,
                               cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg, int* part) {
  if (S <= 0 || nbins <= 0 || n <= 0 || lane < 0 || lane > 1) return cudaErrorInvalidValue;
  *part = 0;
  if (lane == 1) {
    *cfg = {};
    cfg->gridDim = dim3((unsigned)grid_for(n, 8));
    cfg->blockDim = dim3(kThreads);
    return cudaSuccess;
  }
  const long long cells = (long long)S * nbins;
  if (cells >= (1ll << 31)) return cudaErrorInvalidValue;
  // A rank's cells, a multiple of 8 (16 bytes of u16 counts); one CTA an
  // SM, and at least enough CTAs that no thread takes more than
  // kHistChunks chunks of rows.
  *part = (int)(((cells + kCluster - 1) / kCluster + 7) / 8 * 8);
  const long long chunks = (n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long want = (chunks + kHistThreads - 1) / kHistThreads;
  const long long least = (chunks + kHistChunks * kHistThreads - 1) / (kHistChunks * kHistThreads);
  return cluster_config(hist_cluster_kernel, (size_t)((cells + 7) / 8) * 16, kHistThreads, want,
                        px::num_sms() / kCluster * kCluster, least, attr, cfg);
}

// H3. values: f32, or f64 (f64 1) rounded to f32; state: int64 [S, nbins],
// updated in place; lane as hist_config reads it. probe: null, or int64
// [H3_PROBE] (its counter added to, its clocks written).
int px_log_histogram_update(const void* values, int f64, long long n, const void* gids,
                            const void* mask, int S, int nbins, float min_value,
                            float log_gamma, void* state, int lane, void* probe,
                            void* stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  HistArgs a = {};
  cudaError_t err = hist_config(n, S, nbins, lane, attr, &cfg, &a.part);
  if (err != cudaSuccess) return (int)err;
  a.values = values;
  a.f64 = f64;
  a.gids = (const int*)gids;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.S = S;
  a.nbins = nbins;
  a.min_value = min_value;
  a.log_gamma = log_gamma;
  a.state = (unsigned long long*)state;
  a.probe = (long long*)probe;
  a.vec = px::vec_aligned(values, f64 ? px::kF64 : px::kI32) && px::vec_aligned(gids, px::kI32) &&
          (mask == nullptr || (uintptr_t)mask % 8 == 0);
  a.unit_min = min_value == 1.0f;
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, lane == 0 ? hist_cluster_kernel : hist_global_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// H3's launch shape over n rows in ``lane``: out[0] CTAs, out[1] threads a
// CTA, out[2] bytes of dynamic shared memory a CTA.
int px_log_histogram_geometry(long long n, int S, int nbins, int lane, int* out) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int part = 0;
  cudaError_t err = hist_config(n, S, nbins, lane, attr, &cfg, &part);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)cfg.gridDim.x;
  out[1] = (int)cfg.blockDim.x;
  out[2] = (int)cfg.dynamicSmemBytes;
  return 0;
}

int px_empty_launch(int grid, int threads, int smem, void* stream) {
  cudaError_t err = allow_smem(empty_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The SM clock's rate (kHz) of this device, for the probes' clock64 stamps.
int px_sm_clock_khz(int* khz) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(khz, cudaDevAttrClockRate, dev);
}

// mid: f64 [nbins], each bin's value; out: f64 [S, Q]; probe: null or
// int64 [4], CTA 0's clock64 phases.
int px_hist_quantiles(const void* state, int S, int nbins, const void* qs, int Q, const void* mid,
                      void* out, void* probe, void* stream) {
  if (S <= 0 || Q <= 0) return 0;
  const int vec = nbins % 2 == 0 && (uintptr_t)state % 16 == 0;
  const int warps = hq_warps(S);
  hist_quantiles_kernel<<<(S + warps - 1) / warps, warps * 32, 0, (cudaStream_t)stream>>>(
      (const long long*)state, S, nbins, vec, (const double*)qs, Q, (const double*)mid,
      (double*)out, (long long*)probe);
  return (int)cudaGetLastError();
}

// out: {CTAs, threads a CTA, dynamic shared bytes} of px_hist_quantiles'
// launch over S groups on the current device (its shared rows are static).
int px_hist_quantiles_geometry(int S, int* out) {
  const int warps = hq_warps(max(S, 1));
  out[0] = S > 0 ? (S + warps - 1) / warps : 0;
  out[1] = warps * 32;
  out[2] = 0;
  return 0;
}

}  // extern "C"
