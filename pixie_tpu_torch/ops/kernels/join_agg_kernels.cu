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
//      acc[1 + i, g]       += left_vals[i, r] * w      (i < S_l)
//      acc[1 + S_l + j, g] += right_sums[j, jk[r]]      (j < S_r)
//    with g = gids[r], and eff_mask[r] = mask[r] && w > 0 (when asked for),
//    the mask that the left and right min/max specs then fold under (H11).
//    A row that fails the mask, or whose key has no right match, adds
//    nothing: a non-finite value there cannot reach its group's sum (the
//    reference multiplies it by a zero weight, which gives NaN for inf and
//    NaN: PERF.md's Fault-7). val * w is one __dmul_rn, so nvcc cannot fuse
//    it into the add: the product equals the reference's bit for bit, and
//    only the order of the additions differs.
//
//    Design: the per-key statistics (n_right and the S_r right sums, K keys)
//    are staged in shared memory when (1 + S_r) * K doubles fit beside the
//    block's partial sums, else read through the read-only path (__ldg);
//    each block keeps private partial sums of its [1 + S_l + S_r, cap] cells
//    in shared memory when they fit in the opt-in limit and flushes each
//    non-zero cell with one native f64 atomicAdd, else it adds straight into
//    acc in global memory.
//
//    What bounds it on an H100: jk, gids and mask are read once and eff_mask
//    written once (10 bytes a row), plus 8 bytes a row for each left value:
//    18 bytes a row at S_l = 1. The statistics and acc are small at the
//    lane's shapes (K = 16 services, 16 groups). Bytes-bound while the
//    atomics keep up; with few groups every warp's lanes collide on the same
//    shared cells, and the serialised shared atomics set the time, as in H2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using px::allow_smem;
using px::grid_for;
using px::kThreads;

__global__ void __launch_bounds__(kThreads)
    join_agg_fold_kernel(const int* __restrict__ jk, const int* __restrict__ gids,
                         const unsigned char* __restrict__ mask, long long n,
                         const double* __restrict__ n_right, int K,
                         const double* __restrict__ left_vals, int S_l,
                         const double* __restrict__ right_sums, int S_r,
                         double* __restrict__ acc, int cap, unsigned char* __restrict__ eff_mask,
                         int shared_acc, int shared_stats) {
  extern __shared__ double sh_join_agg[];
  const long long cells = (long long)(1 + S_l + S_r) * cap;
  double* part = shared_acc ? sh_join_agg : acc;
  double* stats = sh_join_agg + (shared_acc ? cells : 0);  // [n_right | right_sums]
  if (shared_acc) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) sh_join_agg[c] = 0.0;
  }
  if (shared_stats) {
    const long long nstats = (long long)(1 + S_r) * K;
    for (long long c = threadIdx.x; c < nstats; c += blockDim.x) {
      stats[c] = c < K ? __ldg(n_right + c) : __ldg(right_sums + (c - K));
    }
  }
  if (shared_acc || shared_stats) __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int k = jk[i];
    double w = 0.0;
    if ((mask == nullptr || mask[i]) && k >= 0 && k < K) {
      w = shared_stats ? stats[k] : __ldg(n_right + k);
    }
    const bool eff = w > 0.0;
    if (eff_mask != nullptr) eff_mask[i] = eff ? 1 : 0;
    if (!eff) continue;
    const int g = gids[i];
    if (g < 0 || g >= cap) continue;
    atomicAdd(part + g, w);
    for (int j = 0; j < S_l; ++j) {
      atomicAdd(part + (long long)(1 + j) * cap + g,
                __dmul_rn(left_vals[(long long)j * n + i], w));
    }
    for (int j = 0; j < S_r; ++j) {
      const long long s = (long long)j * K + k;
      const double v = shared_stats ? stats[K + s] : __ldg(right_sums + s);
      atomicAdd(part + (long long)(1 + S_l + j) * cap + g, v);
    }
  }

  if (shared_acc) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      const double v = sh_join_agg[c];
      if (v != 0.0) atomicAdd(acc + c, v);  // NaN != 0: a NaN partial flushes
    }
  }
}

}  // namespace

extern "C" {

// jk, gids: int32 [n]; mask: bool [n] or null; n_right: f64 [K];
// left_vals: f64 [S_l, n]; right_sums: f64 [S_r, K]; acc: f64
// [1 + S_l + S_r, cap], added to in place; eff_mask: bool [n] out, or null.
int px_join_agg_fold(const void* jk, const void* gids, const void* mask, long long n,
                     const void* n_right, int K, const void* left_vals, int S_l,
                     const void* right_sums, int S_r, void* acc, int cap, void* eff_mask,
                     int shared_acc, int shared_stats, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem =
      ((shared_acc ? (size_t)(1 + S_l + S_r) * cap : 0) +
       (shared_stats ? (size_t)(1 + S_r) * K : 0)) * sizeof(double);
  cudaError_t err = allow_smem(join_agg_fold_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  join_agg_fold_kernel<<<grid_for(n, smem > 0 ? 2 : 8), kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const int*)jk, (const int*)gids, (const unsigned char*)mask, n, (const double*)n_right, K,
      (const double*)left_vals, S_l, (const double*)right_sums, S_r, (double*)acc, cap,
      (unsigned char*)eff_mask, shared_acc, shared_stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
