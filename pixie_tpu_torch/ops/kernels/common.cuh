// Launch helpers shared by the kernel sources of pixie_tpu_torch (ctypes
// library built by ops/kernels/__init__.py).
#pragma once

#include <cuda_runtime.h>

namespace px {

constexpr int kThreads = 512;

inline int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Grid of a grid-stride loop over n rows: one thread per row, at most
// ctas_per_sm CTAs of kThreads on each SM.
inline int grid_for(long long n, int ctas_per_sm) {
  long long want = (n + kThreads - 1) / kThreads;
  long long cap = (long long)num_sms() * ctas_per_sm;
  if (want > cap) want = cap;
  return want > 0 ? (int)want : 1;
}

// Raises the kernel's dynamic shared-memory limit when the partial needs
// more than the 48 KB every kernel may use without opting in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace px
