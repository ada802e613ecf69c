// Hand-written CUDA kernels for the device fold of pixie_tpu_torch, built for
// Hopper (sm_90a) with nvcc into a shared library that has a plain C
// interface; ops/kernels/__init__.py builds it at first use and binds it with
// ctypes. Each kernel launches on the CUDA runtime's current device (the
// caller makes its tensors' device current) and on the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// H1 px_segment_rows_sum_i64  replaces pixie_tpu/ops/segment.py
//    limb_einsum_sums + reconstruct_i64 (:235, :269) and seg_count (:616):
//    per-segment sums of R int64 rows plus one presence (row count) row.
// H2 px_segment_sum_f64       replaces pixie_tpu/ops/segment.py seg_sum
//    (:593) on f64 values (its _matvec_sum_f64 lane, :168).
// H3 px_log_histogram_update  replaces pixie_tpu/ops/histogram.py bin_index
//    + update (:49, :59).
// H4 px_hist_quantiles        replaces pixie_tpu/ops/histogram.py
//    quantile_values (:83).
// The sketch kernels (the hash kernel, H5-H10) are in sketch_kernels.cu,
// the launch helpers both use in common.cuh.
//
// The TPU versions ride the matrix unit through one-hot einsums and split
// int64 into 8-bit limbs so that f32 accumulation stays exact; that design
// exists only because the TPU's scatter unit is slow. Here every reduction
// is an atomic add: into a per-CTA partial in shared memory while the
// partial fits in the block's opt-in shared-memory limit, else straight into
// the output in global memory. Each CTA flushes its partial with one global
// atomic per non-zero cell.
//
// What bounds them on an H100: H1-H3 read each input once and write a small
// [cells] output, so they are memory-bound at their bytes over the HBM rate
// when the atomics keep up. With few segments (the main path has 16) every
// warp's lanes collide on the same shared addresses, and the serialised
// shared atomics, not HBM, set the time. H4 reads S x 1024 counts once and
// is latency-bound at small S.
//
// Integer sums are unsigned 64-bit wrapping adds, so they are exact mod 2^64
// like the reference's reconstruct_i64. The f64 sums add in a
// non-deterministic order; PERF.md states their bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using px::allow_smem;
using px::grid_for;
using px::kThreads;

// ---------------------------------------------------------------- H1
__global__ void segment_rows_sum_i64_kernel(const long long* __restrict__ rows, int R,
                                            long long n, const int* __restrict__ gids,
                                            const unsigned char* __restrict__ mask, int S,
                                            unsigned long long* __restrict__ out,
                                            int use_shared) {
  extern __shared__ unsigned long long sh_u64[];
  const long long cells = (long long)(R + 1) * S;
  unsigned long long* acc = use_shared ? sh_u64 : out;
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) sh_u64[c] = 0ull;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && !mask[i]) continue;
    const int g = gids[i];
    if (g < 0 || g >= S) continue;
    for (int r = 0; r < R; ++r) {
      atomicAdd(&acc[(long long)r * S + g], (unsigned long long)rows[(long long)r * n + i]);
    }
    atomicAdd(&acc[(long long)R * S + g], 1ull);
  }
  if (use_shared) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      const unsigned long long v = sh_u64[c];
      if (v != 0ull) atomicAdd(&out[c], v);
    }
  }
}

// ---------------------------------------------------------------- H2
__global__ void segment_sum_f64_kernel(const double* __restrict__ values, long long n,
                                       const int* __restrict__ gids,
                                       const unsigned char* __restrict__ mask, int S,
                                       double* __restrict__ out, int use_shared) {
  extern __shared__ double sh_f64[];
  double* acc = use_shared ? sh_f64 : out;
  if (use_shared) {
    for (int c = threadIdx.x; c < S; c += blockDim.x) sh_f64[c] = 0.0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && !mask[i]) continue;
    const int g = gids[i];
    if (g < 0 || g >= S) continue;
    atomicAdd(&acc[g], values[i]);
  }
  if (use_shared) {
    __syncthreads();
    for (int c = threadIdx.x; c < S; c += blockDim.x) {
      const double v = sh_f64[c];
      if (v != 0.0) atomicAdd(&out[c], v);
    }
  }
}

// ---------------------------------------------------------------- H3
// bin_index exactly as pixie_tpu/ops/histogram.py:49-56 writes it, in f32:
// max(v, min) (NaN propagates, as jnp.maximum does), log(v / min) / log(gamma)
// with the accurate logf (no fast-math), floor, +1, v <= min -> 0, clip.
__device__ __forceinline__ int log_bin(float vf, float min_value, float log_gamma, int nbins) {
  const float v = (vf != vf) ? vf : fmaxf(vf, min_value);
  const float x = floorf(logf(v / min_value) / log_gamma);
  // cvt.rzi.s32.f32 saturates and maps NaN to 0, as XLA's convert does;
  // the +1 wraps like the reference's int32 add.
  int idx = (int)((unsigned int)__float2int_rz(x) + 1u);
  if (vf <= min_value) idx = 0;
  return min(max(idx, 0), nbins - 1);
}

__global__ void log_histogram_update_kernel(const float* __restrict__ values, long long n,
                                            const int* __restrict__ gids,
                                            const unsigned char* __restrict__ mask, int S,
                                            int nbins, float min_value, float log_gamma,
                                            unsigned long long* __restrict__ state,
                                            int use_shared) {
  extern __shared__ unsigned int sh_u32[];
  const long long cells = (long long)S * nbins;
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) sh_u32[c] = 0u;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && !mask[i]) continue;
    const int g = gids[i];
    if (g < 0 || g >= S) continue;
    const long long cell = (long long)g * nbins + log_bin(values[i], min_value, log_gamma, nbins);
    if (use_shared) {
      atomicAdd(&sh_u32[cell], 1u);
    } else {
      atomicAdd(&state[cell], 1ull);
    }
  }
  if (use_shared) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      const unsigned int v = sh_u32[c];
      if (v != 0u) atomicAdd(&state[c], (unsigned long long)v);
    }
  }
}

// ---------------------------------------------------------------- H4
// One CTA per group: a block scan of the group's bins, then for each q the
// first bin whose cumulative count reaches max(q * total, 1e-9) (bin 0 when
// none does, as the reference's argmax over an all-false row gives), and
// that bin's geometric midpoint min * gamma^(bin-1) * sqrt(gamma); bin 0
// gives min, an empty group 0. Counts stay int64: below 2^53 the f64
// comparison against the target is the reference's exactly.
constexpr int kScanThreads = 256;

__global__ void hist_quantiles_kernel(const long long* __restrict__ state, int nbins,
                                      const double* __restrict__ qs, int Q, double min_value,
                                      double gamma, double sqrt_gamma,
                                      double* __restrict__ out) {
  __shared__ long long scan[kScanThreads];
  __shared__ int first_bin;
  const long long* row = state + (long long)blockIdx.x * nbins;
  const int per = (nbins + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, nbins);
  long long mine = 0;
  for (int b = lo; b < hi; ++b) mine += row[b];
  scan[threadIdx.x] = mine;
  __syncthreads();
  // Hillis-Steele inclusive scan over the per-thread sums.
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const long long add = threadIdx.x >= off ? scan[threadIdx.x - off] : 0;
    __syncthreads();
    scan[threadIdx.x] += add;
    __syncthreads();
  }
  const long long total = scan[kScanThreads - 1];
  const long long before = scan[threadIdx.x] - mine;
  for (int q = 0; q < Q; ++q) {
    if (threadIdx.x == 0) first_bin = nbins;
    __syncthreads();
    const double target = fmax(qs[q] * (double)total, 1e-9);
    long long cum = before;
    for (int b = lo; b < hi; ++b) {
      cum += row[b];
      if ((double)cum >= target) {
        atomicMin(&first_bin, b);
        break;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int bin = first_bin == nbins ? 0 : first_bin;
      double v = bin == 0 ? min_value
                          : min_value * pow(gamma, (double)(bin - 1)) * sqrt_gamma;
      out[(long long)blockIdx.x * Q + q] = total > 0 ? v : 0.0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on this device.
int px_smem_optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// out: int64 [R + 1, S], zeroed by the caller; rows: int64 [R, n] row-major.
int px_segment_rows_sum_i64(const void* rows, int R, long long n, const void* gids,
                            const void* mask, int S, void* out, int use_shared,
                            void* stream) {
  const size_t smem = use_shared ? (size_t)(R + 1) * S * sizeof(unsigned long long) : 0;
  cudaError_t err = allow_smem(segment_rows_sum_i64_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  segment_rows_sum_i64_kernel<<<grid_for(n, use_shared ? 2 : 8), kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const long long*)rows, R, n, (const int*)gids, (const unsigned char*)mask, S,
      (unsigned long long*)out, use_shared);
  return (int)cudaGetLastError();
}

// out: f64 [S], zeroed by the caller.
int px_segment_sum_f64(const void* values, long long n, const void* gids, const void* mask,
                       int S, void* out, int use_shared, void* stream) {
  const size_t smem = use_shared ? (size_t)S * sizeof(double) : 0;
  cudaError_t err = allow_smem(segment_sum_f64_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  segment_sum_f64_kernel<<<grid_for(n, use_shared ? 2 : 8), kThreads, smem,
                           (cudaStream_t)stream>>>(
      (const double*)values, n, (const int*)gids, (const unsigned char*)mask, S,
      (double*)out, use_shared);
  return (int)cudaGetLastError();
}

// state: int64 [S, nbins], updated in place.
int px_log_histogram_update(const void* values, long long n, const void* gids,
                            const void* mask, int S, int nbins, float min_value,
                            float log_gamma, void* state, int use_shared, void* stream) {
  const size_t smem = use_shared ? (size_t)S * nbins * sizeof(unsigned int) : 0;
  cudaError_t err = allow_smem(log_histogram_update_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  log_histogram_update_kernel<<<grid_for(n, use_shared ? 2 : 8), kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const float*)values, n, (const int*)gids, (const unsigned char*)mask, S, nbins,
      min_value, log_gamma, (unsigned long long*)state, use_shared);
  return (int)cudaGetLastError();
}

// out: f64 [S, Q].
int px_hist_quantiles(const void* state, int S, int nbins, const void* qs, int Q,
                      double min_value, double gamma, double sqrt_gamma, void* out,
                      void* stream) {
  if (S <= 0) return 0;
  hist_quantiles_kernel<<<S, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)state, nbins, (const double*)qs, Q, min_value, gamma, sqrt_gamma,
      (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
