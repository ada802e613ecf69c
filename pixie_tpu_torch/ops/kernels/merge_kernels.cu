// Cross-shard merge of the fold's states (H29), built for Hopper (sm_90a)
// with the other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it). It launches on the
// CUDA runtime's current device and the caller's stream, allocates nothing,
// and returns the cudaError_t of its launch.
//
// H29 px_merge_states  replaces the elementwise half of
//    pixie_tpu/parallel/pipeline.py _merge_states (:5605): the psum, pmax
//    and pmin of every PSUM / PMAX / PMIN state leaf and of the presence
//    counts over the mesh. (Its TREE half all_gathers the states and merges
//    them pairwise with the UDA's merge, which are H8 and H26 here.)
//
// Operation: out[l] = reduce(stack[0, l], stack[1, l], ..., stack[D-1, l])
// for a [D, L] stack of D shards' flattened leaves, in flat device order
// d = 0..D-1 (acc = stack[0, l]; acc = op(acc, stack[d, l])), one thread an
// element. The order is fixed, so the result is deterministic and equals
// merge_stack_plain (ops/merge.py) bit for bit:
//   sum  int64 as u64 arithmetic (wraps mod 2^64); f64 as IEEE adds in that
//        order (the reference's psum on its CPU mesh adds in the same order);
//        built without fast math, and a loop of adds has nothing to contract
//        into an FMA;
//   max, min  int64 and int32 (HLL registers) as themselves; f64 in the
//        order of H11 (minmax_kernels.cu) and of the in-shard lanes
//        (PERF.md's Fault-5 contract): -0.0 below +0.0 by an order key of
//        the bits; a NaN in the accumulator stays as it is, a NaN that
//        arrives wins and is written as the canonical quiet NaN
//        0x7FF8000000000000. So the merged state is independent of how the
//        rows were cut into shards. (The reference's pmax/pmin on its CPU
//        mesh skip a NaN and keep shard 0's zero on a +-0 tie: ROADMAP
//        Fault-17.)
//
// What bounds it on an H100: bytes. It reads D x L elements once and writes
// L (a few MB at most: 4096 groups x 2048 HLL registers x 8 shards is 256 MB
// only for that one leaf). Consecutive threads read consecutive elements of
// each shard's row, so every load of the d loop is coalesced. No shared
// memory, no atomics, no matrix unit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using px::grid_for;
using px::kThreads;

constexpr long long kLow63 = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kCanonicalNaN = 0x7FF8000000000000LL;

enum Kind { kSum = 0, kMax = 1, kMin = 2 };
enum Type { kI64 = 0, kI32 = 1, kF64 = 2 };

__device__ __forceinline__ long long f64_order_key(long long bits) {
  return bits >= 0 ? bits : (bits ^ kLow63);
}

__device__ __forceinline__ bool is_nan_bits(long long bits) {
  return (bits & kLow63) > 0x7FF0000000000000LL;
}

template <typename T, int KIND>
__global__ void merge_int(const T* __restrict__ stack, int D, long long L,
                          T* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x; l < L; l += stride) {
    T acc = stack[l];
    for (int d = 1; d < D; ++d) {
      T v = stack[(long long)d * L + l];
      if (KIND == kSum) {
        acc = (T)((unsigned long long)acc + (unsigned long long)v);
      } else if (KIND == kMax) {
        acc = v > acc ? v : acc;
      } else {
        acc = v < acc ? v : acc;
      }
    }
    out[l] = acc;
  }
}

__global__ void merge_f64_sum(const double* __restrict__ stack, int D, long long L,
                              double* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x; l < L; l += stride) {
    double acc = stack[l];
    for (int d = 1; d < D; ++d) acc = __dadd_rn(acc, stack[(long long)d * L + l]);
    out[l] = acc;
  }
}

template <bool IS_MIN>
__global__ void merge_f64_minmax(const long long* __restrict__ stack, int D, long long L,
                                 long long* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x; l < L; l += stride) {
    long long acc = stack[l];
    for (int d = 1; d < D; ++d) {
      if (is_nan_bits(acc)) break;  // a NaN in the accumulator stays
      long long v = stack[(long long)d * L + l];
      if (is_nan_bits(v)) {
        acc = kCanonicalNaN;
        break;
      }
      long long kv = f64_order_key(v), ka = f64_order_key(acc);
      if (IS_MIN ? kv < ka : kv > ka) acc = v;
    }
    out[l] = acc;
  }
}

}  // namespace

extern "C" {

// H29. kind: 0 sum, 1 max, 2 min; type: 0 int64, 1 int32, 2 f64. The wrapper
// admits sums of int64 and f64 and max/min of all three.
int px_merge_states(const void* stack, int D, long long L, int kind, int type, void* out,
                    cudaStream_t stream) {
  if (L <= 0) return cudaSuccess;
  if (D < 1) return cudaErrorInvalidValue;
  dim3 grid(grid_for(L, 8)), block(kThreads);
  if (type == kI64) {
    const long long* s = static_cast<const long long*>(stack);
    long long* o = static_cast<long long*>(out);
    if (kind == kSum) merge_int<long long, kSum><<<grid, block, 0, stream>>>(s, D, L, o);
    else if (kind == kMax) merge_int<long long, kMax><<<grid, block, 0, stream>>>(s, D, L, o);
    else if (kind == kMin) merge_int<long long, kMin><<<grid, block, 0, stream>>>(s, D, L, o);
    else return cudaErrorInvalidValue;
  } else if (type == kI32) {
    const int32_t* s = static_cast<const int32_t*>(stack);
    int32_t* o = static_cast<int32_t*>(out);
    if (kind == kMax) merge_int<int32_t, kMax><<<grid, block, 0, stream>>>(s, D, L, o);
    else if (kind == kMin) merge_int<int32_t, kMin><<<grid, block, 0, stream>>>(s, D, L, o);
    else return cudaErrorInvalidValue;
  } else if (type == kF64) {
    if (kind == kSum) {
      merge_f64_sum<<<grid, block, 0, stream>>>(static_cast<const double*>(stack), D, L,
                                                static_cast<double*>(out));
    } else {
      const long long* s = static_cast<const long long*>(stack);
      long long* o = static_cast<long long*>(out);
      if (kind == kMax) merge_f64_minmax<false><<<grid, block, 0, stream>>>(s, D, L, o);
      else if (kind == kMin) merge_f64_minmax<true><<<grid, block, 0, stream>>>(s, D, L, o);
      else return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
