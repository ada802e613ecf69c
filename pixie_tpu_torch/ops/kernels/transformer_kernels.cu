// The transformer UDF's encoder (K21), built for Hopper (sm_90a) with the
// other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it). It launches on
// the CUDA runtime's current device and the caller's stream, allocates
// nothing, and returns the cudaError_t of its launch.
//
// H28 px_encoder_forward replaces pixie_tpu/ops/transformer.py's jitted
//    forward (:76-102): per document, ids [64] (the +1 shift and pad id 0
//    applied by the caller) and its token count; x = embed[ids] + pos;
//    per layer h = x * ln1 / (|x| + 1e-6) * 8, Q, K, V = h Wq, h Wk, h Wv,
//    per head softmax(Q K^T / 4 + key bias (0, or -1e9 for a pad key)) V,
//    x += ctx Wo, h = x * ln2 / (|x| + 1e-6) * 8, x += relu(h W1) W2; then
//    the mean over the real tokens, divided by (|pooled| + 1e-6). Shapes:
//    L 64, d 64, 4 heads of 16, MLP 256, f32 throughout.
//
// Design: one CTA a document, both layers in one launch. x, h, Q, K, V,
// one head's scores and the context sit in shared memory (112 KB; the MLP's
// 64 x 256 hidden reuses Q, K, V and the scores); the weights (2 x 192 KB a
// layer) are read through L2/L1. Every product is computed here on CUDA
// cores in full f32 (no TF32, no tensor cores): a thread per output, its
// dot product in index order. Bound: operations, 14.7 MFLOP a document
// (about 60 GFLOP at 4098 documents, 0.9 ms at 67 TFLOP/s).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int L = 64, D = 64, H = 4, DH = 16, FF = 256;
constexpr int kEncThreads = 256;
// One layer's weights, packed: wq, wk, wv, wo [D, D], w1 [D, FF], w2 [FF, D],
// ln1, ln2 [D] (ops/transformer.py pack_layer).
constexpr int kWq = 0, kWk = D * D, kWv = 2 * D * D, kWo = 3 * D * D, kW1 = 4 * D * D;
constexpr int kW2 = kW1 + D * FF, kLn1 = kW2 + FF * D, kLn2 = kLn1 + D;
constexpr int kLayerFloats = kLn2 + D;
static_assert(kLayerFloats == 49280, "ops/kernels/__init__.py ENCODER_LAYER_FLOATS");
// Shared memory, in floats: x, h, q, k, v, scores (one head), ctx; the MLP
// hidden reuses q..scores.
constexpr int kX = 0, kH = L * D, kQ = 2 * L * D, kK = 3 * L * D, kV = 4 * L * D;
constexpr int kS = 5 * L * D, kC = kS + L * L, kHid = kQ;
constexpr int kSmemFloats = kC + L * D;
static_assert(kHid + L * FF <= kC, "the MLP hidden must fit in q..scores");

// C[L, N] (= or +=) A[L, K] W[K, N]: A and C in shared memory, W global.
template <int K, int N, bool kAccumulate, bool kRelu>
__device__ void matmul(const float* A, const float* __restrict__ W, float* C) {
  for (int o = threadIdx.x; o < L * N; o += kEncThreads) {
    const int r = o / N, c = o - r * N;
    float s = 0.f;
    for (int kk = 0; kk < K; ++kk) s += A[r * K + kk] * W[kk * N + c];
    if (kRelu) s = fmaxf(s, 0.f);
    C[o] = kAccumulate ? C[o] + s : s;
  }
}

// h = x * ln / (|x| + 1e-6) * sqrt(D), row by row.
__device__ void rms_scale(const float* x, const float* __restrict__ ln, float* h, float* nrm) {
  for (int t = threadIdx.x; t < L; t += kEncThreads) {
    float s = 0.f;
    for (int j = 0; j < D; ++j) s += x[t * D + j] * x[t * D + j];
    nrm[t] = sqrtf(s);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < L * D; o += kEncThreads) {
    const int t = o / D, j = o - t * D;
    h[o] = x[o] * ln[j] / (nrm[t] + 1e-6f) * 8.0f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kEncThreads)
    encoder_forward_kernel(const int* __restrict__ ids, const int* __restrict__ lens,
                           const float* __restrict__ embed, const float* __restrict__ pos,
                           const float* __restrict__ layers, int n_layers,
                           float* __restrict__ out) {
  extern __shared__ float sm[];
  __shared__ float nrm[L];
  __shared__ float bias[L];
  __shared__ float pooled[D];
  __shared__ float pnorm;
  float* x = sm + kX;
  float* h = sm + kH;
  float* q = sm + kQ;
  float* k = sm + kK;
  float* v = sm + kV;
  float* sc = sm + kS;
  float* ctx = sm + kC;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = lens[b];
  for (int t = tid; t < L; t += kEncThreads) bias[t] = t < len ? 0.f : -1e9f;
  for (int o = tid; o < L * D; o += kEncThreads) {
    const int t = o / D, j = o - t * D;
    x[o] = embed[(long long)ids[b * L + t] * D + j] + pos[o];
  }
  __syncthreads();
  for (int layer = 0; layer < n_layers; ++layer) {
    const float* w = layers + (long long)layer * kLayerFloats;
    rms_scale(x, w + kLn1, h, nrm);
    matmul<D, D, false, false>(h, w + kWq, q);
    matmul<D, D, false, false>(h, w + kWk, k);
    matmul<D, D, false, false>(h, w + kWv, v);
    __syncthreads();
    for (int hh = 0; hh < H; ++hh) {
      for (int o = tid; o < L * L; o += kEncThreads) {
        const int qi = o / L, ki = o - qi * L;
        float s = 0.f;
        for (int dd = 0; dd < DH; ++dd) s += q[qi * D + hh * DH + dd] * k[ki * D + hh * DH + dd];
        sc[o] = s / 4.0f + bias[ki];
      }
      __syncthreads();
      for (int qi = tid; qi < L; qi += kEncThreads) {  // softmax over the keys
        float m = sc[qi * L];
        for (int ki = 1; ki < L; ++ki) m = fmaxf(m, sc[qi * L + ki]);
        float sum = 0.f;
        for (int ki = 0; ki < L; ++ki) {
          const float e = expf(sc[qi * L + ki] - m);
          sc[qi * L + ki] = e;
          sum += e;
        }
        for (int ki = 0; ki < L; ++ki) sc[qi * L + ki] /= sum;
      }
      __syncthreads();
      for (int o = tid; o < L * DH; o += kEncThreads) {
        const int qi = o / DH, dd = o - qi * DH;
        float s = 0.f;
        for (int ki = 0; ki < L; ++ki) s += sc[qi * L + ki] * v[ki * D + hh * DH + dd];
        ctx[qi * D + hh * DH + dd] = s;
      }
      __syncthreads();
    }
    matmul<D, D, true, false>(ctx, w + kWo, x);
    __syncthreads();
    rms_scale(x, w + kLn2, h, nrm);
    matmul<D, FF, false, true>(h, w + kW1, sm + kHid);
    __syncthreads();
    matmul<FF, D, true, false>(sm + kHid, w + kW2, x);
    __syncthreads();
  }
  const float count = fmaxf((float)min(len, L), 1.0f);
  for (int j = tid; j < D; j += kEncThreads) {
    float s = 0.f;
    for (int t = 0; t < L; ++t) s += (t < len ? 1.f : 0.f) * x[t * D + j];
    pooled[j] = s / count;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int j = 0; j < D; ++j) s += pooled[j] * pooled[j];
    pnorm = sqrtf(s) + 1e-6f;
  }
  __syncthreads();
  for (int j = tid; j < D; j += kEncThreads) out[b * D + j] = pooled[j] / pnorm;
}

}  // namespace

extern "C" {

int px_encoder_forward(const void* ids, const void* lens, int B, const void* embed,
                       const void* pos, const void* layers, int n_layers, void* out,
                       void* stream) {
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = px::allow_smem(encoder_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  encoder_forward_kernel<<<B, kEncThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)lens, (const float*)embed, (const float*)pos,
      (const float*)layers, n_layers, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
