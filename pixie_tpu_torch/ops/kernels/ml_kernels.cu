// The ML lane's kernels (reservoir sampling and k-means), built for Hopper
// (sm_90a) with the other kernel sources into one shared library that has a
// plain C interface (ops/kernels/__init__.py builds and binds it). Each
// launches on the CUDA runtime's current device and the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// H25 px_reservoir_priority replaces pixie_tpu/ops/ml.py _priorities (:37)
//    with K9's 64-bit path (pixie_tpu/ops/hashing.py:22,30,40): row i of a
//    block gets combine(hash64(word_i), hash64(i + salt)) >> 11, as f64 /
//    2^53; a masked row gets -inf. salt is a device scalar (the state's
//    count sum), so the fold never waits for it. One thread a row,
//    grid-stride. Bound: bytes, 17 B a row (the word, the mask, the f64).
// H26 px_reservoir_topk  replaces ml.py reservoir_update (:47),
//    topk_by_priority (:80) and reservoir_merge (:94): per group, the k
//    highest priorities of the state's k slots and the group's candidate
//    rows, in descending order; ties keep the reference's stable order (the
//    state's slots first, then the rows in row order). The caller buckets
//    the rows by group (a stable sort of the gids: order, offsets). One CTA
//    a group. A priority is the 53-bit integer key = p * 2^53 (-inf: -1),
//    which orders them exactly. A row at or below the k-th best key so far
//    cannot enter (it loses to every kept entry, ties included), so once a
//    reservoir is full almost every row is pruned by one compare; the
//    survivors go to a 1024-entry buffer in shared memory that a bitonic
//    sort by (key desc, origin asc) cuts back to k when it fills, and once
//    at the end. Bound: bytes (each row's order index, priority; the
//    state); the time is the gather and the CTA's serial walk of its
//    group's rows.
// H27 px_kmeans_fit      replaces ml.py kmeans_fit (:128, vmapped over
//    groups): one CTA a group, its S x d f32 points and weights in shared
//    memory. Farthest-point seeding from the first live point, min(k, S) -
//    1 steps (dead points -inf), then iters Lloyd steps; distances as
//    sum (p - c)^2; argmin and argmax take the first index; a thread per
//    (center, dim) sums the points in index order (no atomics:
//    deterministic); an empty cluster keeps its center. Bound: operations,
//    a few hundred kFLOP a group: launch latency sets the time.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "hash64.cuh"

namespace {

using px::grid_for;
using px::kThreads;

constexpr double kTwo53 = 9007199254740992.0;

__device__ __forceinline__ double neg_inf() { return __longlong_as_double(0xFFF0000000000000ll); }

// ---------------------------------------------------------------- H25
__global__ void reservoir_priority_kernel(const unsigned long long* __restrict__ words,
                                          long long n, const unsigned char* __restrict__ mask,
                                          const long long* __restrict__ salt,
                                          double* __restrict__ out) {
  const unsigned long long s = (unsigned long long)salt[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && !mask[i]) {
      out[i] = neg_inf();
      continue;
    }
    const unsigned long long h =
        px::combine64(px::hash64(words[i]), px::hash64((unsigned long long)i + s));
    out[i] = (double)(h >> 11) / kTwo53;
  }
}

// ---------------------------------------------------------------- H26
constexpr int kTopkThreads = 256;
constexpr int kTopkCap = 1024;  // candidate buffer entries
constexpr int kTopkMaxK = kTopkCap - kTopkThreads;

// The exact integer key of a priority m / 2^53; -inf (an empty slot, a
// masked row) is -1.
__device__ __forceinline__ long long pri_key(double p) {
  return p >= 0.0 ? (long long)(p * kTwo53) : -1ll;
}

// Whether entry (ka, oa) comes before (kb, ob): higher key, then lower origin.
__device__ __forceinline__ bool before(long long ka, int oa, long long kb, int ob) {
  return ka > kb || (ka == kb && oa < ob);
}

// Bitonic sort of the whole buffer into ``before`` order.
__device__ void sort_buffer(long long* key, int* org) {
  for (int size = 2; size <= kTopkCap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kTopkCap / 2; t += kTopkThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const long long ki = key[i], kj = key[j];
        const int oi = org[i], oj = org[j];
        const bool swap = (i & size) == 0 ? before(kj, oj, ki, oi) : before(ki, oi, kj, oj);
        if (swap) {
          key[i] = kj;
          key[j] = ki;
          org[i] = oj;
          org[j] = oi;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kTopkThreads)
    reservoir_topk_kernel(const long long* __restrict__ st_vals, const double* __restrict__ st_pri,
                          int k, const long long* __restrict__ row_vals,
                          const double* __restrict__ row_pri, const long long* __restrict__ order,
                          const long long* __restrict__ offsets, long long* __restrict__ out_vals,
                          double* __restrict__ out_pri) {
  __shared__ long long key[kTopkCap];
  __shared__ int org[kTopkCap];
  __shared__ int n_buf;
  __shared__ long long thr;
  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  // The state's slots are origins 0..k-1, the group's rows k, k+1, ... in
  // row order; free entries hold a sentinel below every key.
  for (int s = tid; s < kTopkCap; s += kTopkThreads) {
    key[s] = s < k ? pri_key(st_pri[g * k + s]) : LLONG_MIN;
    org[s] = s < k ? s : INT_MAX;
  }
  __syncthreads();
  if (tid == 0) {
    long long lowest = LLONG_MAX;  // the k-th best entry so far
    for (int s = 0; s < k; ++s) lowest = min(lowest, key[s]);
    thr = lowest;
    n_buf = k;
  }
  __syncthreads();
  const long long lo = offsets[g], hi = offsets[g + 1];
  for (long long base = lo; base < hi; base += kTopkThreads) {
    const long long r = base + tid;
    if (r < hi) {
      const long long kr = pri_key(row_pri[order[r]]);
      if (kr > thr) {
        const int pos = atomicAdd(&n_buf, 1);
        key[pos] = kr;
        org[pos] = k + (int)(r - lo);
      }
    }
    __syncthreads();
    if (n_buf > kTopkCap - kTopkThreads) {  // the same for every thread
      sort_buffer(key, org);
      for (int s = k + tid; s < kTopkCap; s += kTopkThreads) {
        key[s] = LLONG_MIN;
        org[s] = INT_MAX;
      }
      if (tid == 0) {
        n_buf = k;
        thr = key[k - 1];
      }
    }
    __syncthreads();
  }
  sort_buffer(key, org);
  for (int s = tid; s < k; s += kTopkThreads) {
    const long long kk = key[s];
    const int o = org[s];
    long long v = 0;  // an empty slot holds 0, as every empty slot of the reference does
    double p = neg_inf();
    if (kk >= 0) {
      p = (double)kk / kTwo53;
      v = o < k ? st_vals[g * k + o] : row_vals[order[lo + (o - k)]];
    }
    out_vals[g * k + s] = v;
    out_pri[g * k + s] = p;
  }
}

// ---------------------------------------------------------------- H27
constexpr int kKmThreads = 256;

__device__ __forceinline__ float sq_dist(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int j = 0; j < d; ++j) {
    const float t = a[j] - b[j];
    s += t * t;
  }
  return s;
}

__global__ void __launch_bounds__(kKmThreads)
    kmeans_fit_kernel(const float* __restrict__ points, const float* __restrict__ weights, int S,
                      int d, int k, int iters, float* __restrict__ centers_out) {
  extern __shared__ float sm[];
  float* pts = sm;            // [S, d]
  float* w = pts + S * d;     // [S]
  float* cen = w + S;         // [k, d]
  float* mind = cen + k * d;  // [S]
  int* assign = reinterpret_cast<int*>(mind + S);  // [S]
  __shared__ int pick;
  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < S * d; i += kKmThreads) pts[i] = points[g * S * d + i];
  for (int i = tid; i < S; i += kKmThreads) w[i] = weights[g * S + i];
  for (int i = tid; i < k * d; i += kKmThreads) cen[i] = 0.f;
  __syncthreads();
  if (tid == 0) {  // the first live point (0 when none is)
    int first = 0;
    for (int p = 0; p < S; ++p) {
      if (w[p] > 0.f) {
        first = p;
        break;
      }
    }
    pick = first;
  }
  __syncthreads();
  for (int j = tid; j < d; j += kKmThreads) cen[j] = pts[pick * d + j];
  __syncthreads();
  const float inf = __int_as_float(0x7F800000);
  for (int i = 1; i < min(k, S); ++i) {  // farthest-point seeding
    for (int p = tid; p < S; p += kKmThreads) {
      float m = inf;
      for (int c = 0; c < i; ++c) m = fminf(m, sq_dist(pts + p * d, cen + c * d, d));
      mind[p] = w[p] > 0.f ? m : -inf;
    }
    __syncthreads();
    if (tid == 0) {
      int best = 0;
      for (int p = 1; p < S; ++p) {
        if (mind[p] > mind[best]) best = p;
      }
      pick = best;
    }
    __syncthreads();
    for (int j = tid; j < d; j += kKmThreads) cen[i * d + j] = pts[pick * d + j];
    __syncthreads();
  }
  for (int it = 0; it < iters; ++it) {  // Lloyd
    for (int p = tid; p < S; p += kKmThreads) {
      int best = 0;
      float bv = inf;
      for (int c = 0; c < k; ++c) {
        const float s = sq_dist(pts + p * d, cen + c * d, d);
        if (s < bv) {
          bv = s;
          best = c;
        }
      }
      assign[p] = best;
    }
    __syncthreads();
    for (int o = tid; o < k * d; o += kKmThreads) {
      const int c = o / d, j = o - c * d;
      float sum = 0.f, wsum = 0.f;
      for (int p = 0; p < S; ++p) {
        const float oh = assign[p] == c ? w[p] : 0.f;
        sum += oh * pts[p * d + j];
        wsum += oh;
      }
      if (wsum > 0.f) cen[o] = sum / fmaxf(wsum, 1e-9f);
    }
    __syncthreads();
  }
  for (int i = tid; i < k * d; i += kKmThreads) centers_out[g * k * d + i] = cen[i];
}

}  // namespace

extern "C" {

int px_reservoir_priority(const void* words, long long n, const void* mask, const void* salt,
                          void* out, void* stream) {
  reservoir_priority_kernel<<<grid_for(n, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)words, n, (const unsigned char*)mask, (const long long*)salt,
      (double*)out);
  return (int)cudaGetLastError();
}

int px_reservoir_topk(const void* st_vals, const void* st_pri, int G, int k, const void* row_vals,
                      const void* row_pri, const void* order, const void* offsets,
                      void* out_vals, void* out_pri, void* stream) {
  if (k < 1 || k > kTopkMaxK) return (int)cudaErrorInvalidValue;
  reservoir_topk_kernel<<<G, kTopkThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)st_vals, (const double*)st_pri, k, (const long long*)row_vals,
      (const double*)row_pri, (const long long*)order, (const long long*)offsets,
      (long long*)out_vals, (double*)out_pri);
  return (int)cudaGetLastError();
}

int px_kmeans_fit(const void* points, const void* weights, int G, int S, int d, int k, int iters,
                  void* centers, void* stream) {
  // points, weights, centers, min distances (f32) and assignments (int);
  // over the card's opt-in limit, allow_smem's error stands.
  const size_t smem = (size_t)(S * d + S + k * d + S) * sizeof(float) + (size_t)S * sizeof(int);
  cudaError_t err = px::allow_smem(kmeans_fit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kmeans_fit_kernel<<<G, kKmThreads, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)weights, S, d, k, iters, (float*)centers);
  return (int)cudaGetLastError();
}

}  // extern "C"
