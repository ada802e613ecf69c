// Segment min/max of the port's group-by (H11), built for Hopper (sm_90a)
// with the other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it).
//
// H11 px_segment_minmax  replaces pixie_tpu/ops/segment.py seg_min / seg_max
//    (:642, :657) and, through seg_max over the widened codes, seg_any and
//    the any() UDA's device lane (:670); the reference's sort-compact lane of
//    the same results (sorted_segment_minmax_compact, :411) is what the tests
//    hold against it under PERF.md's Fault-5 contract.
//
// Operation: state[g] = pick(state[g], values[i]) for every valid row i
// (mask true, 0 <= gid < S), IN PLACE, where pick is min or max. That equals
// the reference's pick(state, seg_fn(values, gids, S, mask)).
//
// Order. int64 compares as itself. f64 compares by an order-preserving
// signed 64-bit key of its bits: a non-negative bit pattern is its own key,
// a negative one (sign bit set) has its other 63 bits flipped, so -0.0
// (key -1) sorts just below +0.0 (key 0), as XLA's scatter lane and
// jnp.minimum/maximum order them. This is the unsigned key of "flip every bit
// of a negative value, only the sign bit of a positive one" with the sign bit
// flipped back, so that native signed atomicMin/atomicMax order it. Every
// NaN maps to the key that wins (LLONG_MAX under max, LLONG_MIN under min),
// which no other value reaches, so NaN propagates as the scatter lane's does;
// a NaN that wins is written back as the one canonical quiet NaN
// 0x7FF8000000000000, and a NaN already in the state stays as it is.
//
// Partials. While S x 8 bytes fits the block's opt-in shared memory, each
// CTA reduces its rows into keys in shared memory (native 64-bit shared
// atomics; the value is read first, so a row that cannot win issues none)
// and flushes each touched cell once into the global state. Beyond that
// every row goes straight to global memory. int64 uses native atomicMin /
// atomicMax on long long. f64 has no atomic min or max, and the state stays
// f64 in memory, so its global update is a compare-and-swap loop on the bits
// that stops as soon as the state already wins.
//
// What bounds it on an H100: it reads each row once (8 + 4 + 1 bytes) and
// writes S x 8 bytes, so it is bytes-bound when the atomics keep up. With few
// groups (the flows path has 4096, config 4 filtered the same) a CTA's
// shared atomics collide; the read-before-atomic skips most of them once a
// group's running extreme settles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using px::allow_smem;
using px::grid_for;
using px::kThreads;

constexpr long long kMaxKey = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kMinKey = -kMaxKey - 1;
constexpr long long kCanonicalNaN = 0x7FF8000000000000LL;

// The order key of an f64 (see the header); NaN takes the winning key.
template <bool IS_MIN>
__device__ __forceinline__ long long f64_key(double v) {
  if (v != v) return IS_MIN ? kMinKey : kMaxKey;
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ kMaxKey);
}

// The bits of the f64 whose key is k; the NaN key gives the canonical NaN.
template <bool IS_MIN>
__device__ __forceinline__ long long f64_bits(long long k) {
  if (k == (IS_MIN ? kMinKey : kMaxKey)) return kCanonicalNaN;
  return k >= 0 ? k : (k ^ kMaxKey);
}

template <bool IS_MIN>
__device__ __forceinline__ bool wins(long long a, long long b) {
  return IS_MIN ? a < b : a > b;
}

template <bool IS_MIN>
__device__ __forceinline__ void update_i64(long long* cell, long long v) {
  // Cells only move one way, so a stale read can only cost an extra atomic.
  if (!wins<IS_MIN>(v, *(volatile long long*)cell)) return;
  if (IS_MIN) {
    atomicMin(cell, v);
  } else {
    atomicMax(cell, v);
  }
}

template <bool IS_MIN>
__device__ __forceinline__ void update_f64(long long* cell, long long key) {
  unsigned long long* addr = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long old = *(volatile unsigned long long*)addr;
  while (true) {
    const double o = __longlong_as_double((long long)old);
    if (o != o) return;  // a NaN in the state stays
    if (!wins<IS_MIN>(key, f64_key<IS_MIN>(o))) return;
    const unsigned long long nw = (unsigned long long)f64_bits<IS_MIN>(key);
    const unsigned long long prev = atomicCAS(addr, old, nw);
    if (prev == old) return;
    old = prev;
  }
}

template <bool IS_MIN, bool F64>
__global__ void segment_minmax_kernel(const long long* __restrict__ values, long long n,
                                      const int* __restrict__ gids,
                                      const unsigned char* __restrict__ mask, int S,
                                      long long* state, int use_shared) {
  extern __shared__ long long sh_keys[];
  const long long empty = IS_MIN ? kMaxKey : kMinKey;
  if (use_shared) {
    for (int c = threadIdx.x; c < S; c += blockDim.x) sh_keys[c] = empty;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && !mask[i]) continue;
    const int g = gids[i];
    if (g < 0 || g >= S) continue;
    const long long raw = values[i];
    const long long key = F64 ? f64_key<IS_MIN>(__longlong_as_double(raw)) : raw;
    if (use_shared) {
      if (!wins<IS_MIN>(key, sh_keys[g])) continue;
      if (IS_MIN) {
        atomicMin(&sh_keys[g], key);
      } else {
        atomicMax(&sh_keys[g], key);
      }
    } else if (F64) {
      update_f64<IS_MIN>(state + g, key);
    } else {
      update_i64<IS_MIN>(state + g, key);
    }
  }
  if (use_shared) {
    __syncthreads();
    for (int c = threadIdx.x; c < S; c += blockDim.x) {
      const long long key = sh_keys[c];
      if (key == empty) continue;
      if (F64) {
        update_f64<IS_MIN>(state + c, key);
      } else {
        update_i64<IS_MIN>(state + c, key);
      }
    }
  }
}

template <bool IS_MIN, bool F64>
cudaError_t launch_minmax(const void* values, long long n, const void* gids, const void* mask,
                          int S, void* state, int use_shared, cudaStream_t stream) {
  const size_t smem = use_shared ? (size_t)S * sizeof(long long) : 0;
  cudaError_t err = allow_smem(segment_minmax_kernel<IS_MIN, F64>, smem);
  if (err != cudaSuccess) return err;
  segment_minmax_kernel<IS_MIN, F64><<<grid_for(n, use_shared ? 2 : 8), kThreads, smem,
                                       stream>>>(
      (const long long*)values, n, (const int*)gids, (const unsigned char*)mask, S,
      (long long*)state, use_shared);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// values: int64 or f64 [n] (is_f64); state: the same type [S], updated in
// place.
int px_segment_minmax(const void* values, long long n, const void* gids, const void* mask,
                      int S, void* state, int is_min, int is_f64, int use_shared,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_min) {
    return (int)(is_f64 ? launch_minmax<true, true>(values, n, gids, mask, S, state,
                                                     use_shared, s)
                        : launch_minmax<true, false>(values, n, gids, mask, S, state,
                                                      use_shared, s));
  }
  return (int)(is_f64 ? launch_minmax<false, true>(values, n, gids, mask, S, state,
                                                    use_shared, s)
                      : launch_minmax<false, false>(values, n, gids, mask, S, state,
                                                     use_shared, s));
}

}  // extern "C"
