// Hand-written CUDA kernels of the 64-bit hashes that no path calls yet,
// built for Hopper (sm_90a) into the same ctypes library as the other
// sources (ops/kernels/__init__.py). Each launches on the CUDA runtime's
// current device and the caller's stream, allocates nothing, and returns
// the cudaError_t of its launch.
//
// H31 px_hash_columns  replaces pixie_tpu/ops/hashing.py hash_columns
//    (:48-53): per row, hash64 of the first column's word, then combine
//    with each further column's hash64, left to right. A column is 8-byte
//    words (an int64, or a float64 read as its bits: the reference's
//    bitcast, so -0.0 and +0.0, and NaN payloads, hash apart; :30-37) or
//    bools (one byte, 0 or 1). Up to 8 columns.
// H32 px_clz64         replaces pixie_tpu/ops/hashing.py clz64 (:56-62):
//    the leading zeros of each u64, 64 for zero (__clzll).
//
// What bounds them on an H100: both read each input once and write each
// output once, with a few dozen integer operations a row (H31: two 64-bit
// multiplies a column), so at 2^21 rows they are bytes-bound: a grid-stride
// loop, one thread a row, consecutive threads on consecutive words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hash64.cuh"

namespace {

using px::grid_for;
using px::kThreads;

constexpr int kMaxCols = 8;

struct Columns {
  const void* ptr[kMaxCols];
};

__device__ __forceinline__ unsigned long long word_of(const Columns& cols, int c, int bool_mask,
                                                      long long i) {
  if ((bool_mask >> c) & 1) return ((const unsigned char*)cols.ptr[c])[i] ? 1ull : 0ull;
  return ((const unsigned long long*)cols.ptr[c])[i];
}

// ---------------------------------------------------------------- H31
__global__ void hash_columns_kernel(Columns cols, int ncols, int bool_mask,
                                    unsigned long long seed_word, long long n,
                                    unsigned long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned long long h = px::splitmix64(word_of(cols, 0, bool_mask, i) ^ seed_word);
    for (int c = 1; c < ncols; ++c) {
      h = px::combine64(h, px::splitmix64(word_of(cols, c, bool_mask, i) ^ seed_word));
    }
    out[i] = h;
  }
}

// ---------------------------------------------------------------- H32
__global__ void clz64_kernel(const unsigned long long* __restrict__ x, long long n,
                             int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = __clzll((long long)x[i]);
  }
}

}  // namespace

extern "C" {

// c0..c7: the columns (8-byte words, or bools where bit c of bool_mask is
// set); seed_word: (seed * 0x9E3779B97F4A7C15) mod 2^64; out: u64 [n].
int px_hash_columns(const void* c0, const void* c1, const void* c2, const void* c3,
                    const void* c4, const void* c5, const void* c6, const void* c7, int ncols,
                    int bool_mask, unsigned long long seed_word, long long n, void* out,
                    void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  Columns cols = {{c0, c1, c2, c3, c4, c5, c6, c7}};
  hash_columns_kernel<<<grid_for(n, 8), kThreads, 0, (cudaStream_t)stream>>>(
      cols, ncols, bool_mask, seed_word, n, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// x: u64 [n]; out: int32 [n].
int px_clz64(const void* x, long long n, void* out, void* stream) {
  clz64_kernel<<<grid_for(n, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)x, n, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
