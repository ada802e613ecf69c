// The predicate-batched fold (K16), built for Hopper (sm_90a) with the other
// kernel sources into one shared library that has a plain C interface
// (ops/kernels/__init__.py builds and binds it). Each launches on the CUDA
// runtime's current device and the caller's stream, allocates nothing, and
// returns the cudaError_t of its launch.
//
// H22 px_pred_slot_masks      replaces the slot masks of the batched scan
//    body, pixie_tpu/parallel/pipeline.py:5539-5590 (_build_batched_fold,
//    :6655): for each row, bit s of its uint32 is set where the block mask
//    (validity and the pass's gid window) holds and every term of slot s
//    holds. A term compares one column, widened exactly (an int, bool or
//    code block to int64 plus its frame-of-reference offset, f32 to f64),
//    against a threshold (==, !=, <, <=, >, >=; IEEE, so NaN compares false
//    but for !=, and -0.0 == +0.0), or (op 6) tests its int64 value for
//    membership of a sorted list.
// H23 px_batched_segment_sums replaces the vmapped sum-family updates of
//    the same body (pipeline.py:5597-5600 over apply_updates): per slot, the
//    per-group sums of R integer rows and F f64 rows over the rows whose
//    slot bit is set, and the slot's presence (its row count); each row read
//    where the fold staged it (rows.cuh).
//
// The reference evaluates the (B, T) term table as (B, T, rows) gathers and
// a (B, T, L, rows) IN-list compare, then runs B masked copies of every
// update. Here each row is read once for every slot:
//
// - H22: one thread a row (grid-stride). The term table (at most 32 slots x
//   16 terms) sits in shared memory, read by every thread alike (broadcast).
//   A row loads each distinct term column once, then walks its slots' terms;
//   a membership list is scanned when short and binary-searched when long
//   (at most 1024 members, read through the read-only cache). Nothing is
//   materialized per (slot, term, row). Bound: bytes (the base mask, each
//   term column once, 4 B a row written); the compares are a few per byte.
// - H23: rows read as staged (rows.cuh: an integer row's bool, uint8,
//   uint16, int32 or int64 with its offset; f64, or an integer row rounded
//   to f64), gids and slot bits as 16-byte vectors, 8 rows a thread, each
//   row once for every slot. Up to 8 slots and 64 groups (the slot lane)
//   each warp stages its rows in shared memory bucketed by gid and each
//   lane adds the rows of its (slot, gid) pairs into sums of its own: no
//   atomics, and the last CTA writes the outputs (no fill, the same bits
//   every run); else a CTA's partial in shared memory while it fits, else
//   global atomics (ops/kernels/__init__.py h23_lane). Integer adds wrap as
//   unsigned 64-bit (exact mod 2^64); f64 sums keep H2's bound (PERF.md).
//   Bound: bytes (gids, bits and the R + F rows as staged read once, the
//   outputs written once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "rows.cuh"

namespace {

using px::allow_smem;
using px::grid_for;
using px::kThreads;

constexpr int kMaxSlots = 32;
constexpr int kMaxTerms = 16;
constexpr int kMaxPredCols = 16;
constexpr int kTermWords = 7;  // col, stack, op, thr_i, thr_f bits, lut_off, lut_len
constexpr int kLinearMembers = 16;

// Staged block dtypes (ops/kernels/__init__.py PRED_COL_KINDS).
enum ColKind { kBool = 0, kU8 = 1, kU16 = 2, kI32 = 3, kI64 = 4, kF32 = 5, kF64 = 6 };

struct PredCols {
  const void* ptr[kMaxPredCols];
  long long offset[kMaxPredCols];
  int kind[kMaxPredCols];
  int n;
};

// The int64 value (int, bool and code blocks: the staged value plus its
// offset, wrapping) or the f64 value (float blocks) of column j at row i.
__device__ __forceinline__ void load_col(const PredCols& c, int j, long long i, long long* iv,
                                         double* fv) {
  const unsigned long long off = (unsigned long long)c.offset[j];
  switch (c.kind[j]) {
    case kBool:
      iv[j] = ((const unsigned char*)c.ptr[j])[i] != 0;
      break;
    case kU8:
      iv[j] = (long long)((unsigned long long)((const unsigned char*)c.ptr[j])[i] + off);
      break;
    case kU16:
      iv[j] = (long long)((unsigned long long)((const unsigned short*)c.ptr[j])[i] + off);
      break;
    case kI32:
      iv[j] = (long long)((unsigned long long)(long long)((const int*)c.ptr[j])[i] + off);
      break;
    case kI64:
      iv[j] = (long long)((unsigned long long)((const long long*)c.ptr[j])[i] + off);
      break;
    case kF32:
      fv[j] = (double)((const float*)c.ptr[j])[i];
      break;
    default:
      fv[j] = ((const double*)c.ptr[j])[i];
      break;
  }
}

template <typename V>
__device__ __forceinline__ bool compare(int op, V v, V t) {
  switch (op) {
    case 0: return v == t;
    case 1: return v != t;
    case 2: return v < t;
    case 3: return v <= t;
    case 4: return v > t;
    default: return v >= t;
  }
}

// Whether v is one of the len sorted values at lut[off].
__device__ __forceinline__ bool member(const long long* __restrict__ lut, long long off, int len,
                                       long long v) {
  const long long* a = lut + off;
  if (len <= kLinearMembers) {
    for (int k = 0; k < len; ++k) {
      if (__ldg(a + k) == v) return true;
    }
    return false;
  }
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < len && __ldg(a + lo) == v;
}

// ---------------------------------------------------------------- H22
__global__ void pred_slot_masks_kernel(PredCols cols, const unsigned char* __restrict__ base,
                                       long long n, const long long* __restrict__ terms, int B,
                                       int T, const long long* __restrict__ lut,
                                       unsigned int slot_on, unsigned int* __restrict__ out) {
  extern __shared__ long long sh_terms[];
  const int words = B * T * kTermWords;
  for (int k = threadIdx.x; k < words; k += blockDim.x) sh_terms[k] = terms[k];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned int bits = 0u;
    if (base[i]) {
      long long iv[kMaxPredCols];
      double fv[kMaxPredCols];
      for (int j = 0; j < cols.n; ++j) load_col(cols, j, i, iv, fv);
      for (int s = 0; s < B; ++s) {
        if (!((slot_on >> s) & 1u)) continue;
        bool ok = true;
        for (int t = 0; t < T && ok; ++t) {
          const long long* w = sh_terms + (s * T + t) * kTermWords;
          const int op = (int)w[2];
          if (op < 0) continue;  // a pad term
          const int c = (int)w[0];
          if (w[1] != 0) {
            ok = compare<double>(op, fv[c], __longlong_as_double(w[4]));
          } else if (op == 6) {
            ok = member(lut, w[5], (int)w[6], iv[c]);
          } else {
            ok = compare<long long>(op, iv[c], w[3]);
          }
        }
        if (ok) bits |= 1u << s;
      }
    }
    out[i] = bits;
  }
}

// ---------------------------------------------------------------- H23
// The rows of one launch, each read where the fold staged it (rows.cuh): R
// integer rows (a value plus its offset, wrapping) and F f64 rows (f64, or
// an integer row's value plus its offset rounded to f64), the gids and slot
// bits they share, the outputs [B][R + 1][S] (int64, the presence row R) and
// [B][F][S] (f64); the slot lane's [grid][cells] partials and its ticket (0
// between launches).
constexpr int kSumMaxRows = 16;  // integer rows, and f64 rows, a launch
constexpr int kSumThreads = 512;

struct SumArgs {
  const void* iptr[kSumMaxRows];
  long long ioff[kSumMaxRows];
  int ikind[kSumMaxRows];
  const void* fptr[kSumMaxRows];
  long long foff[kSumMaxRows];
  int fkind[kSumMaxRows];
  unsigned int ivec, fvec;  // bit r: row r takes vector loads
  int R, F, B, S;
  int vec;  // gids and bits take vector loads
  const int* gids;
  const unsigned int* bits;
  long long n;
  unsigned long long* out_i;
  double* out_f;
  unsigned long long* partials;
  unsigned int* ticket;
};

__device__ __forceinline__ double sum_f64_value(const SumArgs& a, int r, unsigned long long raw) {
  return a.fkind[r] == px::kF64 ? __longlong_as_double((long long)raw)
                                : __ll2double_rn((long long)(raw + (unsigned long long)a.foff[r]));
}

// After each CTA wrote its partial (a.partials[blockIdx.x], ``cells``
// 8-byte words, the first cells_i integers, the rest f64): the last CTA to
// take a ticket adds every CTA's partial in CTA order, k threads a cell,
// each every k-th partial (sixteen loads in flight), then the cell's thread
// their k sums in order, and writes both outputs whole; it sets the ticket
// back to 0. ``scratch``: max(cells, blockDim) words of shared memory.
__device__ void finish_partials(const SumArgs& a, int cells, int cells_i,
                                unsigned long long* scratch) {
  __shared__ bool sh_last;
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
    unsigned long long si = 0ull;
    double sf = 0.0;
    for (int b = t / cells; b < grid; b += 16 * k) {
      unsigned long long v[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int bq = b + q * k;
        v[q] = bq < grid ? __ldcg(a.partials + (size_t)bq * cells + c) : 0ull;
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (c < cells_i) si += v[q];
        else sf = __dadd_rn(sf, __longlong_as_double((long long)v[q]));
      }
    }
    scratch[t] = c < cells_i ? si : (unsigned long long)__double_as_longlong(sf);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    if (c < cells_i) {
      unsigned long long t = 0ull;
      for (int q = 0; q < k; ++q) t += scratch[q * cells + c];
      a.out_i[c] = t;
    } else {
      double t = 0.0;
      for (int q = 0; q < k; ++q) t = __dadd_rn(t, __longlong_as_double((long long)scratch[q * cells + c]));
      a.out_f[c - cells_i] = t;
    }
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// The slot lane (at most 8 slots, S <= kSumSlotMaxS, a warp's staged rows
// and its lanes' sums fit enough warps a CTA): no atomics on the sums. Each warp takes 256
// rows at a time (a lane 8 consecutive rows: gids and slot bits as 16-byte
// vectors, each value row as staged) and stages them in shared memory
// bucketed by gid: a row's place in its bucket is its rank among the lanes
// holding its gid (a ballot of each of its bits) after the rows before it,
// so the order is the same every run. Lane l owns the (slot, gid) pairs p =
// l, l + 32, ...; for each it adds its bucket's rows whose bit slot is set,
// in registers, and that into its own sums in shared memory once a tile
// ([pair][R + 1 + F][lane]: no conflicts). Then the CTA adds each output
// cell over its warps in order into its partial, and the last CTA adds the
// partials in CTA order (finish_partials): no fill, the same bits every run.
constexpr int kSumStage = 32 * px::kRowsPerThread;  // rows a warp stages
constexpr int kSumSlotMaxS = 64;                     // the slot lane's largest S

__global__ void __launch_bounds__(kSumThreads) batched_sums_slot_kernel(const SumArgs a) {
  constexpr int J = px::kRowsPerThread;
  extern __shared__ unsigned long long sh_slot[];
  const int S = a.S, R = a.R, RI = a.R + 1, F = a.F, B = a.B, NV = a.R + a.F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  const int kb = 32 - __clz(S);  // bits of a bucket, 0 .. S
  const int pairs = B * S, PL = (pairs + 31) / 32;
  const int per_warp = kSumStage * (1 + NV) + PL * (RI + F) * 32 + (S + 2) / 2;
  unsigned long long* st_b = sh_slot + (size_t)warp * per_warp;  // [stage]: slot bits
  unsigned long long* st_v = st_b + kSumStage;                     // [NV][stage]
  unsigned long long* acc = st_v + (size_t)NV * kSumStage;        // [PL][RI + F][32]
  unsigned int* cnt = reinterpret_cast<unsigned int*>(acc + (size_t)PL * (RI + F) * 32);
  for (int c = 0; c < PL * (RI + F); ++c) acc[c * 32 + lane] = 0ull;
  const unsigned int slots = B < 32 ? (1u << B) - 1u : 0xFFFFFFFFu;
  const long long tiles = (a.n + kSumStage - 1) / kSumStage;
  const long long wstride = (long long)gridDim.x * warps;
  for (long long tile = (long long)blockIdx.x * warps + warp; tile < tiles; tile += wstride) {
    const long long i0 = tile * kSumStage + lane * J;
    int g[J];
    px::load_gids8(a.gids, nullptr, i0, a.n, S, a.vec != 0, g);
    unsigned long long raw[J];
    px::load_vals8(a.bits, px::kU32, i0, a.n, a.vec != 0, raw);
    for (int b = lane; b <= S; b += 32) cnt[b] = 0u;
    __syncwarp();
    // Each row's place in its bucket (bucket S: rows no slot takes): the
    // lanes holding its bucket found by a ballot of each of the bucket's
    // bits, its rank among them after the rows before it; the lowest of them
    // moves the bucket's count on.
    unsigned int bt[J];
    int key[J], pos[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      bt[j] = g[j] >= 0 ? (unsigned int)raw[j] & slots : 0u;
      key[j] = bt[j] != 0u ? g[j] : S;
      unsigned int peers = 0xFFFFFFFFu;
      for (int b = 0; b < kb; ++b) {
        const bool bit = (key[j] >> b) & 1;
        const unsigned int m = __ballot_sync(0xFFFFFFFFu, bit);
        peers &= bit ? m : ~m;
      }
      const int leader = __ffs(peers) - 1;
      const unsigned int base = cnt[key[j]];
      __syncwarp();
      if (lane == leader) cnt[key[j]] = base + (unsigned int)__popc(peers);
      pos[j] = (int)(base + __popc(peers & below));
      __syncwarp();
    }
    // The buckets' starts: an exclusive scan of the counts, a lane taking
    // ceil((S + 1) / 32) consecutive buckets.
    const int per = (S + 32) / 32;
    unsigned int mine = 0u;
    for (int q = 0; q < per; ++q) {
      const int b = lane * per + q;
      if (b <= S) mine += cnt[b];
    }
    unsigned int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    __syncwarp();
    unsigned int run = incl - mine;
    for (int q = 0; q < per; ++q) {
      const int b = lane * per + q;
      if (b <= S) {
        const unsigned int c = cnt[b];
        cnt[b] = run;
        run += c;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < J; ++j) {
      pos[j] += (int)cnt[key[j]];
      if (key[j] < S) st_b[pos[j]] = bt[j];
    }
    for (int r = 0; r < NV; ++r) {
      unsigned long long x[J];
      if (r < R) {
        px::load_vals8(a.iptr[r], a.ikind[r], i0, a.n, (a.ivec >> r) & 1u, x);
#pragma unroll
        for (int j = 0; j < J; ++j) x[j] += (unsigned long long)a.ioff[r];
      } else {
        const int f = r - R;
        px::load_vals8(a.fptr[f], a.fkind[f], i0, a.n, (a.fvec >> f) & 1u, x);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          x[j] = (unsigned long long)__double_as_longlong(sum_f64_value(a, f, x[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (key[j] < S) st_v[r * kSumStage + pos[j]] = x[j];
      }
    }
    __syncwarp();
    // The lane's pairs: each adds its bucket's rows of its slot, the count
    // and the first value row in one walk, each further row in its own.
    for (int k = 0; k < PL; ++k) {
      const int pr = lane + 32 * k;
      if (pr >= pairs) break;
      const int sl = pr / S, gq = pr % S;
      const int lo = (int)cnt[gq], hi = (int)cnt[gq + 1];
      unsigned long long* cell = acc + (size_t)k * (RI + F) * 32 + lane;
      unsigned long long c = 0ull, vi = 0ull;
      double vf = 0.0;
      for (int i = lo; i < hi; ++i) {  // branch-free: the slot's bit selects
        const unsigned long long on = (st_b[i] >> sl) & 1ull;
        c += on;
        if (R > 0) {
          vi += on ? st_v[i] : 0ull;
        } else if (F > 0) {
          const double x = __longlong_as_double((long long)st_v[i]);
          vf = on ? __dadd_rn(vf, x) : vf;
        }
      }
      cell[R * 32] += c;
      if (R > 0) cell[0] += vi;
      else if (F > 0) {
        double* d = reinterpret_cast<double*>(cell + RI * 32);
        *d = __dadd_rn(*d, vf);
      }
      for (int r = 1; r < NV; ++r) {
        unsigned long long ui = 0ull;
        double uf = 0.0;
        for (int i = lo; i < hi; ++i) {
          const unsigned long long on = (st_b[i] >> sl) & 1ull;
          const unsigned long long x = st_v[r * kSumStage + i];
          if (r < R) ui += on ? x : 0ull;
          else uf = on ? __dadd_rn(uf, __longlong_as_double((long long)x)) : uf;
        }
        if (r < R) {
          cell[r * 32] += ui;
        } else {
          double* d = reinterpret_cast<double*>(cell + (RI + r - R) * 32);
          *d = __dadd_rn(*d, uf);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  // The CTA's partial: output cell (slot, row, g) over the warps in order.
  const int cells_i = B * RI * S, total = cells_i + B * F * S;
  unsigned long long* part = a.partials + (size_t)blockIdx.x * total;
  for (int oc = threadIdx.x; oc < total; oc += blockDim.x) {
    const bool is_i = oc < cells_i;
    const int rel = is_i ? oc : oc - cells_i, rows = is_i ? RI : F;
    const int sl = rel / (rows * S), row = rel / S % rows + (is_i ? 0 : RI), gq = rel % S;
    const int pr = sl * S + gq, k = pr / 32, owner = pr % 32;
    unsigned long long vi = 0ull;
    double vf = 0.0;
    for (int w = 0; w < warps; ++w) {
      const unsigned long long v = sh_slot[(size_t)w * per_warp + kSumStage * (1 + NV) +
                                           ((size_t)k * (RI + F) + row) * 32 + owner];
      if (is_i) vi += v;
      else vf = __dadd_rn(vf, __longlong_as_double((long long)v));
    }
    __stcg(part + oc, is_i ? vi : (unsigned long long)__double_as_longlong(vf));
  }
  finish_partials(a, total, cells_i, sh_slot);
}

// The shared lane (a CTA's [B][R + 1 + F][S] partial fits its shared
// memory) and the global lane: 8 rows a thread read as staged, and for each
// set slot bit of a row one atomic a row and cell, into the CTA's partial
// (flushed by one global atomic a non-zero cell) or into the outputs, zeroed
// by the caller. f64 adds land in a non-deterministic order (H2's bound).
__global__ void __launch_bounds__(kSumThreads) batched_sums_atomic_kernel(const SumArgs a,
                                                                          int use_shared) {
  constexpr int J = px::kRowsPerThread;
  extern __shared__ unsigned long long sh_acc[];
  const int S = a.S, R = a.R, RI = a.R + 1, F = a.F;
  const long long cells_i = (long long)a.B * RI * S, cells_f = (long long)a.B * F * S;
  unsigned long long* acc_i = use_shared ? sh_acc : a.out_i;
  double* acc_f = use_shared ? reinterpret_cast<double*>(sh_acc + cells_i) : a.out_f;
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells_i + cells_f; c += blockDim.x) sh_acc[c] = 0ull;
    __syncthreads();
  }
  const unsigned int slots = a.B < 32 ? (1u << a.B) - 1u : 0xFFFFFFFFu;
  const long long chunks = (a.n + J - 1) / J;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; c0 < chunks; c0 += stride) {
    const long long i0 = c0 * J;
    int g[J];
    px::load_gids8(a.gids, nullptr, i0, a.n, S, a.vec != 0, g);
    unsigned long long raw[J];
    px::load_vals8(a.bits, px::kU32, i0, a.n, a.vec != 0, raw);
    unsigned int bt[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      bt[j] = g[j] >= 0 ? (unsigned int)raw[j] & slots : 0u;
      for (unsigned int b = bt[j]; b != 0u; b &= b - 1u) {
        atomicAdd(acc_i + ((long long)(__ffs(b) - 1) * RI + R) * S + g[j], 1ull);
      }
    }
    for (int r = 0; r < R; ++r) {
      unsigned long long x[J];
      px::load_vals8(a.iptr[r], a.ikind[r], i0, a.n, (a.ivec >> r) & 1u, x);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const unsigned long long v = x[j] + (unsigned long long)a.ioff[r];
        for (unsigned int b = bt[j]; b != 0u; b &= b - 1u) {
          atomicAdd(acc_i + ((long long)(__ffs(b) - 1) * RI + r) * S + g[j], v);
        }
      }
    }
    for (int r = 0; r < F; ++r) {
      unsigned long long x[J];
      px::load_vals8(a.fptr[r], a.fkind[r], i0, a.n, (a.fvec >> r) & 1u, x);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (bt[j] == 0u) continue;
        const double v = sum_f64_value(a, r, x[j]);
        for (unsigned int b = bt[j]; b != 0u; b &= b - 1u) {
          atomicAdd(acc_f + ((long long)(__ffs(b) - 1) * F + r) * S + g[j], v);
        }
      }
    }
  }
  if (use_shared) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells_i; c += blockDim.x) {
      const unsigned long long v = sh_acc[c];
      if (v != 0ull) atomicAdd(&a.out_i[c], v);
    }
    const double* sf = reinterpret_cast<const double*>(sh_acc + cells_i);
    for (long long c = threadIdx.x; c < cells_f; c += blockDim.x) {
      const double v = sf[c];
      if (v != 0.0) atomicAdd(&a.out_f[c], v);  // NaN too
    }
  }
}

}  // namespace

extern "C" {

// col_ptrs, col_offsets (int64) and col_kinds (int32): ncols host arrays;
// base: bool [n]; terms: int64 [B * T, 7]; lut: int64; out: uint32 [n].
int px_pred_slot_masks(const void* col_ptrs, const void* col_offsets, const void* col_kinds,
                       int ncols, const void* base, long long n, const void* terms, int B,
                       int T, const void* lut, unsigned int slot_on, void* out, void* stream) {
  if (ncols < 0 || ncols > kMaxPredCols || B < 1 || B > kMaxSlots || T < 1 || T > kMaxTerms) {
    return (int)cudaErrorInvalidValue;
  }
  PredCols cols = {};
  for (int j = 0; j < ncols; ++j) {
    cols.ptr[j] = (const void*)((const long long*)col_ptrs)[j];
    cols.offset[j] = ((const long long*)col_offsets)[j];
    cols.kind[j] = ((const int*)col_kinds)[j];
  }
  cols.n = ncols;
  const size_t smem = (size_t)B * T * kTermWords * sizeof(long long);
  cudaError_t err = allow_smem(pred_slot_masks_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pred_slot_masks_kernel<<<grid_for(n, 8), kThreads, smem, (cudaStream_t)stream>>>(
      cols, (const unsigned char*)base, n, (const long long*)terms, B, T,
      (const long long*)lut, slot_on, (unsigned int*)out);
  return (int)cudaGetLastError();
}

// H23. iptrs/ikinds/ioffs: R integer rows as staged (rows.cuh kinds but
// kPresence and kF64; ioffs added to the values); fptrs/fkinds/foffs: F f64
// rows (kF64, or an integer kind whose value plus its offset rounds to
// f64); gids: int32 [n]; bits: uint32 [n]; out_i: int64 [B, R + 1, S];
// out_f: f64 [B, F, S]. lane 0: the slot lane, ``threads`` threads a CTA,
// grid CTAs, partials [grid][B (R + 1 + F) S] 8-byte words and ticket (0)
// its scratch, the outputs written whole; 1: shared partials; 2: global
// atomics (1 and 2: outputs zeroed by the caller; ops/kernels/__init__.py
// h23_lane chooses).
int px_batched_segment_sums(const void* const* iptrs, const int* ikinds, const long long* ioffs,
                            int R, const void* const* fptrs, const int* fkinds,
                            const long long* foffs, int F, long long n, const void* gids,
                            const void* bits, int B, int S, void* out_i, void* out_f, int lane,
                            int threads, int grid, void* partials, void* ticket, void* stream) {
  if (B < 1 || B > kMaxSlots || R < 0 || R > kSumMaxRows || F < 0 || F > kSumMaxRows ||
      S < 1 || n < 1 || threads < 32 || threads > kSumThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  SumArgs a = {};
  for (int r = 0; r < R; ++r) {
    if (ikinds[r] == px::kPresence || ikinds[r] == px::kF64) return (int)cudaErrorInvalidValue;
    a.iptr[r] = iptrs[r];
    a.ikind[r] = ikinds[r];
    a.ioff[r] = ioffs[r];
    if (px::vec_aligned(iptrs[r], ikinds[r])) a.ivec |= 1u << r;
  }
  for (int r = 0; r < F; ++r) {
    if (fkinds[r] == px::kPresence) return (int)cudaErrorInvalidValue;
    a.fptr[r] = fptrs[r];
    a.fkind[r] = fkinds[r];
    a.foff[r] = foffs[r];
    if (px::vec_aligned(fptrs[r], fkinds[r])) a.fvec |= 1u << r;
  }
  a.R = R;
  a.F = F;
  a.B = B;
  a.S = S;
  a.vec = px::vec_aligned(gids, px::kI32) && px::vec_aligned(bits, px::kU32);
  a.gids = (const int*)gids;
  a.bits = (const unsigned int*)bits;
  a.n = n;
  a.out_i = (unsigned long long*)out_i;
  a.out_f = (double*)out_f;
  a.partials = (unsigned long long*)partials;
  a.ticket = (unsigned int*)ticket;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t cells = (size_t)B * (R + 1 + F) * S;
  cudaError_t err;
  if (lane == 0) {
    if (grid < 1 || partials == nullptr || ticket == nullptr) return (int)cudaErrorInvalidValue;
    if (S > kSumSlotMaxS) return (int)cudaErrorInvalidValue;
    const size_t PL = ((size_t)B * S + 31) / 32;
    const size_t per_warp = (size_t)kSumStage * (1 + R + F) + PL * (R + 1 + F) * 32 + (S + 2) / 2;
    const size_t smem = (size_t)(threads / 32) * per_warp * sizeof(unsigned long long);
    err = allow_smem(batched_sums_slot_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    batched_sums_slot_kernel<<<grid, threads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const int use_shared = lane == 1;
  const size_t smem = use_shared ? cells * sizeof(unsigned long long) : 0;
  err = allow_smem(batched_sums_atomic_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  batched_sums_atomic_kernel<<<grid_for((n + 7) / 8, use_shared ? 2 : 8), kThreads, smem, st>>>(
      a, use_shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
