// Typed row loads shared by H1 and H3's gids (hopper_kernels.cu), H5 and H6
// (sketch_kernels.cu) and H11 (minmax_kernels.cu):
// a column is read where the fold staged it (bool, uint8, uint16, int32 or
// int64, a frame-of-reference offset beside it) and widened in registers,
// 8 rows a thread, as 16-byte vectors where every pointer allows it, with
// the streaming hint (read once: evict first, so that a fold's state keeps
// the L2).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace px {

// How a row's bytes become its 64-bit value (ops/kernels/__init__.py
// ROW_KINDS): kPresence reads nothing (the row is the presence count);
// unsigned kinds zero-extend, kI32 sign-extends; kI64 and kF64 are the
// 8 bytes as they are (kF64: the bits of a double).
enum RowKind { kPresence = 0, kU8 = 1, kU16 = 2, kI32 = 3, kI64 = 4, kU32 = 5, kF64 = 6 };

constexpr int kRowsPerThread = 8;

// Whether a row of ``kind`` at ``p`` takes vector loads of 8 rows at every
// multiple of 8 rows: 8-byte alignment for bytes, 16 for the rest.
inline bool vec_aligned(const void* p, int kind) {
  const uintptr_t a = (uintptr_t)p;
  if (kind == kPresence || p == nullptr) return true;
  return kind == kU8 ? a % 8 == 0 : a % 16 == 0;
}

// g[j] = the gid of row i0 + j when the row is valid (i < n, mask set or
// no mask, 0 <= gid < S), else -1.
__device__ __forceinline__ void load_gids8(const int* __restrict__ gids,
                                           const unsigned char* __restrict__ mask,
                                           long long i0, long long n, int S, bool vec,
                                           int (&g)[kRowsPerThread]) {
  if (vec && i0 + kRowsPerThread <= n) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(gids + i0));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(gids + i0 + 4));
    g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
    g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
    if (mask != nullptr) {
      const uint2 m = __ldcs(reinterpret_cast<const uint2*>(mask + i0));
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if ((((j < 4 ? m.x : m.y) >> (8 * (j & 3))) & 0xFFu) == 0u) g[j] = -1;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long i = i0 + j;
      g[j] = (i < n && (mask == nullptr || mask[i])) ? gids[i] : -1;
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (g[j] >= S) g[j] = -1;
    if (g[j] < 0) g[j] = -1;
  }
}

__device__ __forceinline__ unsigned long long load_one(const void* __restrict__ p, int kind,
                                                       long long i) {
  switch (kind) {
    case kU8: return (unsigned long long)((const unsigned char*)p)[i];
    case kU16: return (unsigned long long)((const unsigned short*)p)[i];
    case kI32: return (unsigned long long)(long long)((const int*)p)[i];
    case kU32: return (unsigned long long)((const unsigned int*)p)[i];
    case kI64:
    case kF64: return ((const unsigned long long*)p)[i];
    default: return 1ull;  // kPresence
  }
}

// v[j] = row i0 + j of a typed row, widened to 64 bits (0 past n).
__device__ __forceinline__ void load_vals8(const void* __restrict__ p, int kind, long long i0,
                                           long long n, bool vec,
                                           unsigned long long (&v)[kRowsPerThread]) {
  if (vec && i0 + kRowsPerThread <= n) {
    if (kind == kU8) {
      const uint2 w = __ldcs(reinterpret_cast<const uint2*>((const unsigned char*)p + i0));
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        v[j] = ((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xFFull;
      }
    } else if (kind == kU16) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>((const unsigned short*)p + i0));
      const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) v[j] = (u[j >> 1] >> (16 * (j & 1))) & 0xFFFFull;
    } else if (kind == kI32 || kind == kU32) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>((const int*)p + i0));
      const int4 b = __ldcs(reinterpret_cast<const int4*>((const int*)p + i0 + 4));
      const int u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        v[j] = kind == kI32 ? (unsigned long long)(long long)u[j]
                            : (unsigned long long)(unsigned int)u[j];
      }
    } else if (kind == kI64 || kind == kF64) {
      const longlong2* q = reinterpret_cast<const longlong2*>((const long long*)p + i0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const longlong2 x = __ldcs(q + k);
        v[2 * k] = (unsigned long long)x.x;
        v[2 * k + 1] = (unsigned long long)x.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) v[j] = 1ull;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const long long i = i0 + j;
      v[j] = i < n ? load_one(p, kind, i) : 0ull;
    }
  }
}

}  // namespace px
