// The t-digest's k1-scale cluster of a mid-quantile, shared by H7
// (tdigest_kernels.cu) and H8 (sketch_kernels.cu): the plain version's
// arithmetic (ops/tdigest.py _cluster_ids), each f32 step rounded on its
// own and the asin taken in f64 and rounded to f32 (CUDA's asin(double),
// which torch's CUDA asin of a double tensor calls too). So a kernel's
// clusters equal the plain version's on the card bit for bit, and the
// cluster is nondecreasing in q: f32 inputs a ulp apart give asin values
// far more than f64's error apart.
#pragma once

#include <cuda_runtime.h>

namespace px {

constexpr float kTdPiF = 3.14159265358979323846f;

// The f32 steps after the asin: / pi + 0.5, * C, floor, clip.
__device__ __forceinline__ int td_k_cluster(float a, int C) {
  const float k = __fadd_rn(__fdiv_rn(a, kTdPiF), 0.5f);
  const int cid = __float2int_rz(floorf(__fmul_rn(k, (float)C)));
  return min(max(cid, 0), C - 1);
}

// The cluster of mid-quantile q: clip(q, 1e-7, 1 - 1e-7), 2q - 1, the asin,
// td_k_cluster. CUDA's asinf lies within a few ulps of the f64 asin
// rounded to f32; where the f32 steps after it give one cluster for every
// value 16 ulps either side of asinf's, that is the cluster, else the f64
// asin decides.
__device__ __forceinline__ int td_q_cluster(float q, int C) {
  q = fminf(fmaxf(q, 1e-7f), (float)(1.0 - 1e-7));
  const float x = __fsub_rn(__fmul_rn(2.0f, q), 1.0f);
  const float a32 = asinf(x);
  const float d = fmaxf(fabsf(a32) * 0x1p-19f, 1e-30f);
  const int lo = td_k_cluster(__fsub_rn(a32, d), C);
  if (lo == td_k_cluster(__fadd_rn(a32, d), C)) return lo;
  return td_k_cluster(__double2float_rn(asin((double)x)), C);
}

}  // namespace px
