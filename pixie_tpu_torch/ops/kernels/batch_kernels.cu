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
//    per-group sums of R int64 rows and F f64 rows over the rows whose slot
//    bit is set, and the slot's presence (its row count).
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
// - H23: H1's and H2's design (hopper_kernels.cu). Per-CTA partials of every
//   slot's [R + 1 + F, S] cells in shared memory while B (R + 1 + F) S 8
//   bytes fit the opt-in limit, else global atomics. A row's values are read
//   once and added into each set slot, walking the bits with __ffs. Integer
//   adds wrap as unsigned 64-bit (exact mod 2^64); f64 adds land in a
//   non-deterministic order (H2's bound, PERF.md). Bound: bytes (gids, bits
//   and the R + F rows read once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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
__global__ void batched_segment_sums_kernel(const long long* __restrict__ irows, int R,
                                            const double* __restrict__ frows, int F, long long n,
                                            const int* __restrict__ gids,
                                            const unsigned int* __restrict__ bits, int B, int S,
                                            unsigned long long* __restrict__ out_i,
                                            double* __restrict__ out_f, int use_shared) {
  extern __shared__ unsigned long long sh_acc[];
  const long long cells_i = (long long)B * (R + 1) * S;
  const long long cells_f = (long long)B * F * S;
  unsigned long long* acc_i = use_shared ? sh_acc : out_i;
  double* acc_f = use_shared ? reinterpret_cast<double*>(sh_acc + cells_i) : out_f;
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells_i + cells_f; c += blockDim.x) sh_acc[c] = 0ull;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned int b = bits[i];
    if (B < 32) b &= (1u << B) - 1u;
    if (b == 0u) continue;
    const int g = gids[i];
    if (g < 0 || g >= S) continue;
    while (b != 0u) {
      const int s = __ffs(b) - 1;
      b &= b - 1u;
      unsigned long long* ai = acc_i + (long long)s * (R + 1) * S + g;
      for (int r = 0; r < R; ++r) {
        atomicAdd(ai + (long long)r * S, (unsigned long long)irows[(long long)r * n + i]);
      }
      atomicAdd(ai + (long long)R * S, 1ull);
      double* af = acc_f + (long long)s * F * S + g;
      for (int f = 0; f < F; ++f) atomicAdd(af + (long long)f * S, frows[(long long)f * n + i]);
    }
  }
  if (use_shared) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells_i; c += blockDim.x) {
      const unsigned long long v = sh_acc[c];
      if (v != 0ull) atomicAdd(&out_i[c], v);
    }
    const double* sf = reinterpret_cast<const double*>(sh_acc + cells_i);
    for (long long c = threadIdx.x; c < cells_f; c += blockDim.x) {
      const double v = sf[c];
      if (v != 0.0) atomicAdd(&out_f[c], v);
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

// irows: int64 [R, n]; frows: f64 [F, n]; gids: int32 [n]; bits: uint32 [n];
// out_i: int64 [B, R + 1, S] and out_f: f64 [B, F, S], zeroed by the caller.
int px_batched_segment_sums(const void* irows, int R, const void* frows, int F, long long n,
                            const void* gids, const void* bits, int B, int S, void* out_i,
                            void* out_f, int use_shared, void* stream) {
  if (B < 1 || B > kMaxSlots) return (int)cudaErrorInvalidValue;
  const size_t smem =
      use_shared ? (size_t)B * (R + 1 + F) * S * sizeof(unsigned long long) : 0;
  cudaError_t err = allow_smem(batched_segment_sums_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  batched_segment_sums_kernel<<<grid_for(n, use_shared ? 2 : 8), kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const long long*)irows, R, (const double*)frows, F, n, (const int*)gids,
      (const unsigned int*)bits, B, S, (unsigned long long*)out_i, (double*)out_f, use_shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
