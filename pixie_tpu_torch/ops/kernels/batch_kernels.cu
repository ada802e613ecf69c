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
// - H22 runs the table as the host compiled it (ops/batched.py
//   compile_terms): each distinct term (column, op, threshold or member
//   list) once, with ``need``, the slots that hold it, so a row's bits are
//   base ? slot_on & ~OR{need[u] : term u false} : 0 and the cost grows
//   with the distinct terms, not with the slots. 8 rows a thread: the mask
//   as one 8-byte load, each column once through rows.cuh's 16-byte loads
//   (loaded whatever the mask holds, so no load waits on another), the
//   bits out as two 16-byte streaming stores. The program and the lists
//   that fit sit in shared memory: a list of span <= 2^16 as a bitmap (one
//   load a row), others sorted (a lower bound by a fixed count of
//   halvings), in global memory past 32 KB of lists. Nothing is indexed at
//   run time but shared memory, so no row state spills to local memory.
//   The first design ran one row a thread over every (slot, term)
//   with the row's columns in arrays indexed at run time: 0.0458 ms at the
//   soak's 7 slots against a bound of 0.0094, 0.639 at 32 (PERF.md).
//   Bound: bytes (the base mask, each term column once, 4 B a row written).
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

constexpr int kMaxSlots = 32;  // a row's slot bits are one uint32
constexpr int kMaxPredCols = 16;
constexpr int kMaxProgTerms = 512;  // distinct terms: at most kMaxSlots x 16
constexpr int kProgWords = 8;  // col, code, thr, form, off, len, lo, need
constexpr int kListSharedWords = 4096;  // int64 words of the lists in shared memory
constexpr int kPredThreads = 256;
constexpr int kPredCtasPerSm = 8;
constexpr int kPredRows = 8;  // rows a thread

// Staged block dtypes (ops/kernels/__init__.py PRED_COL_KINDS).
enum ColKind { kBool = 0, kU8 = 1, kU16 = 2, kI32 = 3, kI64 = 4, kF32 = 5, kF64 = 6 };
// A term's code (ops/batched.py compile_terms): 0-5 an int64 compare (==,
// !=, <, <=, >, >=), 6 membership of an int64 list, 8 + op an f64 compare.
enum Code { kIn = 6, kFloat = 8 };
// Where a membership list lies: sorted in global memory, sorted in shared
// memory, or a bitmap of its span in shared memory.
enum ListForm { kListGlobal = 0, kListSorted = 1, kListBitmap = 2 };

struct PredCols {
  const void* ptr[kMaxPredCols];
  long long offset[kMaxPredCols];
  int kind[kMaxPredCols];
  unsigned int vec;  // bit j: column j takes vector loads
};

// v[r] = row i0 + r of a term column as its stack holds it: an int, bool or
// code block's value plus its offset (wrapping) as int64 bits, a float
// block's value as f64 bits (f32 widened exactly); 0 past n.
__device__ __forceinline__ void load_term8(const void* __restrict__ p, int kind,
                                           unsigned long long off, long long i0, long long n,
                                           bool vec, unsigned long long (&v)[kPredRows]) {
  if (kind == kF32) {
    const float* f = static_cast<const float*>(p);
    if (vec && i0 + kPredRows <= n) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(f + i0));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(f + i0 + 4));
      const float x[kPredRows] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < kPredRows; ++r) v[r] = (unsigned long long)__double_as_longlong(x[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kPredRows; ++r) {
        v[r] = i0 + r < n ? (unsigned long long)__double_as_longlong((double)f[i0 + r]) : 0ull;
      }
    }
    return;
  }
  px::load_vals8(p, kind == kBool ? (int)px::kU8 : kind, i0, n, vec, v);
  if (kind != kF64) {
#pragma unroll
    for (int r = 0; r < kPredRows; ++r) v[r] += off;
  }
}

// Whether v is one of the len sorted members at a (shared or, with
// kGlobal, global memory): a lower bound by a fixed count of halvings, the
// same for every lane of a term.
template <bool kGlobal>
__device__ __forceinline__ bool in_sorted(const long long* a, int len, long long v) {
  if (len == 0) return false;
  int at = 0, m = len;
  while (m > 1) {
    const int half = m >> 1;
    if ((kGlobal ? __ldg(a + at + half) : a[at + half]) < v) at += half;
    m -= half;
  }
  if ((kGlobal ? __ldg(a + at) : a[at]) < v) ++at;
  return at < len && (kGlobal ? __ldg(a + at) : a[at]) == v;
}

template <int kOp, typename V>
__device__ __forceinline__ bool op_holds(V x, V t) {
  if (kOp == 0) return x == t;
  if (kOp == 1) return x != t;
  if (kOp == 2) return x < t;
  if (kOp == 3) return x <= t;
  if (kOp == 4) return x > t;
  return x >= t;
}

// A false term sets its need slots in the fail masks: an int64 compare of
// op kOp, or (kFloat) an f64 one (IEEE: NaN passes != alone).
template <int kOp, bool kFloat>
__device__ __forceinline__ void compare_term(const unsigned long long (&v)[kPredRows], long long t,
                                             unsigned int need, unsigned int (&fail)[kPredRows]) {
#pragma unroll
  for (int r = 0; r < kPredRows; ++r) {
    const bool ok = kFloat ? op_holds<kOp>(__longlong_as_double((long long)v[r]),
                                           __longlong_as_double(t))
                           : op_holds<kOp>((long long)v[r], t);
    fail[r] |= ok ? 0u : need;
  }
}

// ---------------------------------------------------------------- H22
// Each thread takes 8 rows: the base mask as one 8-byte load, each column
// through load_term8 once (16-byte loads where aligned), loaded whatever
// the mask holds, then every distinct term of the column on the 8 rows:
// a false term sets its ``need`` slots in the row's fail mask. The columns
// are walked in the program's order (terms sorted by column), so nothing
// is indexed at run time but shared memory. A term's op (and a list's
// form) is chosen once a term, so each row takes one compare a term.
__global__ void __launch_bounds__(kPredThreads)
    pred_slot_masks_kernel(PredCols cols, const unsigned char* __restrict__ base, int base_vec,
                           long long n, const long long* __restrict__ prog, int U,
                           const long long* __restrict__ lists, int shared_words,
                           unsigned int slot_on, unsigned int* __restrict__ out, int out_vec) {
  extern __shared__ long long sh_prog[];  // [U][kProgWords] terms, then shared_words of lists
  __shared__ const void* c_ptr[kMaxPredCols];
  __shared__ unsigned long long c_off[kMaxPredCols];
  __shared__ int c_kind[kMaxPredCols];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kMaxPredCols; ++j) {
      c_ptr[j] = cols.ptr[j];
      c_off[j] = (unsigned long long)cols.offset[j];
      c_kind[j] = cols.kind[j];
    }
  }
  const int term_words = U * kProgWords;
  for (int k = threadIdx.x; k < term_words + shared_words; k += blockDim.x) {
    sh_prog[k] = k < term_words ? prog[k] : lists[k - term_words];
  }
  __syncthreads();
  const long long* sh_lists = sh_prog + term_words;
  const long long stride = (long long)gridDim.x * blockDim.x * kPredRows;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kPredRows; i0 < n;
       i0 += stride) {
    const bool full = i0 + kPredRows <= n;
    unsigned int b[kPredRows];
    if (base_vec && full) {
      const uint2 m = __ldcs(reinterpret_cast<const uint2*>(base + i0));
#pragma unroll
      for (int r = 0; r < kPredRows; ++r) b[r] = ((r < 4 ? m.x : m.y) >> (8 * (r & 3))) & 0xFFu;
    } else {
#pragma unroll
      for (int r = 0; r < kPredRows; ++r) b[r] = i0 + r < n ? base[i0 + r] : 0u;
    }
    unsigned int fail[kPredRows];
#pragma unroll
    for (int r = 0; r < kPredRows; ++r) fail[r] = 0u;
    unsigned long long v[kPredRows];
    int cur = -1;
    for (int u = 0; u < U; ++u) {
      const long long* w = sh_prog + u * kProgWords;
      const int c = (int)w[0];
      if (c != cur) {  // the next column: its 8 values, once
        cur = c;
        load_term8(c_ptr[c], c_kind[c], c_off[c], i0, n, (cols.vec >> c) & 1u, v);
      }
      const int code = (int)w[1];
      const unsigned int need = (unsigned int)w[7];
      switch (code) {
        case 0: compare_term<0, false>(v, w[2], need, fail); break;
        case 1: compare_term<1, false>(v, w[2], need, fail); break;
        case 2: compare_term<2, false>(v, w[2], need, fail); break;
        case 3: compare_term<3, false>(v, w[2], need, fail); break;
        case 4: compare_term<4, false>(v, w[2], need, fail); break;
        case 5: compare_term<5, false>(v, w[2], need, fail); break;
        case kFloat + 0: compare_term<0, true>(v, w[2], need, fail); break;
        case kFloat + 1: compare_term<1, true>(v, w[2], need, fail); break;
        case kFloat + 2: compare_term<2, true>(v, w[2], need, fail); break;
        case kFloat + 3: compare_term<3, true>(v, w[2], need, fail); break;
        case kFloat + 4: compare_term<4, true>(v, w[2], need, fail); break;
        case kFloat + 5: compare_term<5, true>(v, w[2], need, fail); break;
        default: {  // kIn
          const int form = (int)w[3], off = (int)w[4], len = (int)w[5];
          const unsigned long long lo = (unsigned long long)w[6];
          if (form == kListBitmap) {
#pragma unroll
            for (int r = 0; r < kPredRows; ++r) {
              const unsigned long long at = v[r] - lo;
              const bool ok = at < (unsigned long long)len &&
                  ((unsigned long long)sh_lists[off + (int)(at >> 6)] >> (at & 63ull)) & 1ull;
              fail[r] |= ok ? 0u : need;
            }
          } else if (form == kListSorted) {
#pragma unroll
            for (int r = 0; r < kPredRows; ++r) {
              fail[r] |= in_sorted<false>(sh_lists + off, len, (long long)v[r]) ? 0u : need;
            }
          } else {
#pragma unroll
            for (int r = 0; r < kPredRows; ++r) {
              fail[r] |= in_sorted<true>(lists + off, len, (long long)v[r]) ? 0u : need;
            }
          }
        }
      }
    }
    unsigned int bits[kPredRows];
#pragma unroll
    for (int r = 0; r < kPredRows; ++r) bits[r] = b[r] ? slot_on & ~fail[r] : 0u;
    if (out_vec && full) {
      __stcs(reinterpret_cast<uint4*>(out + i0), make_uint4(bits[0], bits[1], bits[2], bits[3]));
      __stcs(reinterpret_cast<uint4*>(out + i0 + 4), make_uint4(bits[4], bits[5], bits[6], bits[7]));
    } else {
#pragma unroll
      for (int r = 0; r < kPredRows; ++r) {
        if (i0 + r < n) out[i0 + r] = bits[r];
      }
    }
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

// H22's launch over n rows with U program terms and shared_words shared
// list words: out[0] CTAs, out[1] threads a CTA, out[2] dynamic shared bytes.
int px_pred_slot_masks_geometry(long long n, int U, int shared_words, int* out) {
  long long want = ((n + kPredRows - 1) / kPredRows + kPredThreads - 1) / kPredThreads;
  const long long cap = (long long)px::num_sms() * kPredCtasPerSm;
  if (want > cap) want = cap;
  out[0] = want > 0 ? (int)want : 1;
  out[1] = kPredThreads;
  out[2] = (int)(((size_t)U * kProgWords + shared_words) * sizeof(long long));
  return 0;
}

// col_ptrs, col_offsets (int64) and col_kinds (int32): ncols host arrays;
// base: bool [n]; prog: int64 [U, 8] (ops/batched.py compile_terms: terms
// sorted by column, every column index below ncols); lists: int64, the
// first shared_words of them copied to shared memory; out: uint32 [n].
int px_pred_slot_masks(const void* col_ptrs, const void* col_offsets, const void* col_kinds,
                       int ncols, const void* base, long long n, const void* prog, int U,
                       const void* lists, int shared_words, unsigned int slot_on, void* out,
                       void* stream) {
  if (ncols < 0 || ncols > kMaxPredCols || U < 0 || U > kMaxProgTerms || shared_words < 0 ||
      shared_words > kListSharedWords || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  PredCols cols = {};
  for (int j = 0; j < ncols; ++j) {
    cols.ptr[j] = (const void*)((const long long*)col_ptrs)[j];
    cols.offset[j] = ((const long long*)col_offsets)[j];
    cols.kind[j] = ((const int*)col_kinds)[j];
    if (cols.kind[j] < kBool || cols.kind[j] > kF64) return (int)cudaErrorInvalidValue;
    const int row_kind = cols.kind[j] == kBool ? (int)px::kU8
                         : cols.kind[j] == kF32 ? (int)px::kI32 : cols.kind[j];
    if (px::vec_aligned(cols.ptr[j], row_kind)) cols.vec |= 1u << j;
  }
  int geo[3];
  px_pred_slot_masks_geometry(n, U, shared_words, geo);
  cudaError_t err = allow_smem(pred_slot_masks_kernel, (size_t)geo[2]);
  if (err != cudaSuccess) return (int)err;
  pred_slot_masks_kernel<<<geo[0], geo[1], geo[2], (cudaStream_t)stream>>>(
      cols, (const unsigned char*)base, px::vec_aligned(base, px::kU8), n,
      (const long long*)prog, U, (const long long*)lists, shared_words, slot_on,
      (unsigned int*)out, px::vec_aligned(out, px::kU32));
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
