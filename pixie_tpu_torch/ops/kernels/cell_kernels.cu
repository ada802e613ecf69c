// The sketches' int-dictionary cell lane, built for Hopper (sm_90a) with the
// other kernel sources into one shared library that has a plain C interface
// (ops/kernels/__init__.py builds and binds it). Each launches on the CUDA
// runtime's current device and the caller's stream, allocates nothing, and
// returns the cudaError_t of its launch.
//
// H20 px_hll_cell_update      replaces pixie_tpu/ops/hll.py cell_update
//    (:82): for every cell (g, c) with hist[g, c] > 0, register
//    reg(lut[c]) of group g takes the max with rho(lut[c]).
// H21 px_countmin_cell_update replaces pixie_tpu/ops/countmin.py
//    cell_update (:82) and the UDA's total (hist.sum(axis=1)): for every
//    cell and depth row d, hist[g, c] is added to bucket (h1 + d * h2) &
//    (width - 1) of group g, (h1, h2) = hash32_pair(lut[c], seed 1), and
//    to total[g].
//
// A cell is a (group, value code) pair of a small-domain int column staged
// as dictionary codes; hist counts the rows of each cell. Every row of a
// cell hashes alike, so one update per cell gives the registers and
// buckets the row path (H5, H6) gives. The hashes are sketch_hash.cuh's,
// the functions H5 and the hash kernel use.
//
// What bounds them on an H100: the cells number at most G * C <= 8192 (the
// pipeline's budget), so one thread per cell, a few hundred ns of launch
// and hashing; the atomics touch at most depth * G * C buckets. Neither
// HBM nor the ALUs are near their limits: launch latency sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sketch_hash.cuh"

namespace {

using px::grid_for;
using px::kThreads;

// ---------------------------------------------------------------- H20
__global__ void hll_cell_update_kernel(const long long* __restrict__ hist,
                                       const unsigned long long* __restrict__ lut, int G, int C,
                                       int precision, int* state) {
  const long long cells = (long long)G * C;
  const int m = 1 << precision;
  const int rho_max = 32 - precision + 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cells; i += stride) {
    if (hist[i] <= 0) continue;
    const int g = (int)(i / C);
    const int c = (int)(i - (long long)g * C);
    const uint32_t h = px::hash32(lut[c], 0u);
    const int reg = (int)(h >> (32 - precision));
    const int rho = min(px::clz32(h << precision) + 1, rho_max);
    int* cell = state + (long long)g * m + reg;
    if (*cell < rho) atomicMax(cell, rho);
  }
}

// ---------------------------------------------------------------- H21
__global__ void countmin_cell_update_kernel(const long long* __restrict__ hist,
                                            const unsigned long long* __restrict__ lut, int G,
                                            int C, int depth, int width,
                                            unsigned long long* __restrict__ cm,
                                            unsigned long long* __restrict__ total) {
  const long long cells = (long long)G * C;
  const uint32_t wmask = (uint32_t)width - 1u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cells; i += stride) {
    const unsigned long long cnt = (unsigned long long)hist[i];
    if (cnt == 0ull) continue;
    const int g = (int)(i / C);
    const int c = (int)(i - (long long)g * C);
    const uint2 h = px::hash32_pair(lut[c], 1u);
    unsigned long long* row = cm + (long long)g * depth * width;
    for (int d = 0; d < depth; ++d) {
      atomicAdd(&row[(long long)d * width + ((h.x + (uint32_t)d * h.y) & wmask)], cnt);
    }
    atomicAdd(&total[g], cnt);
  }
}

}  // namespace

extern "C" {

// hist: int64 [G, C]; lut: int64 [C]; state: int32 [G, 2^precision],
// updated in place.
int px_hll_cell_update(const void* hist, const void* lut, int G, int C, int precision,
                       void* state, void* stream) {
  const long long cells = (long long)G * C;
  hll_cell_update_kernel<<<grid_for(cells, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)hist, (const unsigned long long*)lut, G, C, precision, (int*)state);
  return (int)cudaGetLastError();
}

// hist: int64 [G, C]; lut: int64 [C]; cm: int64 [G, depth, width] and
// total: int64 [G], updated in place.
int px_countmin_cell_update(const void* hist, const void* lut, int G, int C, int depth,
                            int width, void* cm, void* total, void* stream) {
  const long long cells = (long long)G * C;
  countmin_cell_update_kernel<<<grid_for(cells, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)hist, (const unsigned long long*)lut, G, C, depth, width,
      (unsigned long long*)cm, (unsigned long long*)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
