// Raw -> plan converters of device-resident ingest (ops/codec.py
// convert_block), built for Hopper (sm_90a) with the other kernel sources
// into one shared library that has a plain C interface
// (ops/kernels/__init__.py builds and binds it). It launches on the CUDA
// runtime's current device and the caller's stream, allocates nothing, and
// returns the cudaError_t of its launch.
//
// H24 px_ring_convert  replaces pixie_tpu/ops/codec.py _converter (:479) and
//    convert_block (:512): a resident ring block in its raw dtype (bool,
//    int32, int64, f64) becomes the block a query's stream plan stages:
//      raw      a cast (integers keep their low bytes, as astype wraps;
//               ints round to nearest to f32/f64; f64 -> f32 as below);
//      narrow   (int64(x) - off), its low bytes in the destination type;
//      f32      f64 -> f32 (cvt.rn.f32.f64): round to nearest even,
//               overflow to inf, subnormals kept (no flush: built without
//               fast math), a NaN keeping its sign and the top 23 bits of
//               its payload, quieted, as numpy's astype on the host;
//      intdict  min(lower_bound(lut, x), C - 1) in uint8/uint16 codes
//               (searchsorted's left side; the LUT sorted int64, C >= 1).
//    Each is bit for bit the host pack of the same rows (pack_stream_window).
//
//    A window of a ring sharded over D logical shards of one card is a
//    [D, nblk, b] block, and its slice of a streamed staging [D, N, b][:,
//    lo:hi] is D runs of nblk * b elements N * b apart: the launch takes the
//    D runs of L elements, each source and destination shard at its own
//    stride, so one launch converts a window's D slices.
//
// What bounds it on an H100: bytes. It reads each raw element once and
// writes each converted one once (a 2^21-row int64 -> uint16 window is 21 MB,
// ~6 us at 3.35 TB/s), and the LUT once a CTA. A grid of (x, D): blockIdx.y
// a shard, one thread an element in a grid-stride loop over the shard's L
// elements (no division by L), templated on (kind, source, destination) so
// the loop body has no branch on types. intdict stages the LUT in shared memory when
// it fits in 48 KB (C <= 6144, every LUT of the cell lane: C <= 256) and
// searches it there; a larger LUT (up to uint16 codes' 65536 entries,
// 512 KB) is searched in global memory through the read-only cache. No
// matrix product, so no wgmma and no TMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using px::grid_for;
using px::kThreads;

// Kinds as the wrapper passes them (f32 is the f64 -> f32 cast of raw);
// kIntDictSmem is the shared-memory LUT variant, chosen here.
enum Kind { kRaw = 0, kNarrow = 1, kF32 = 2, kIntDict = 3, kIntDictSmem = 4 };
constexpr int kSmemLut = 6144;  // int64 LUT entries in 48 KB

template <typename D>
__device__ __forceinline__ D low_bytes(unsigned long long v) {
  if constexpr (std::is_same<D, bool>::value) {
    return v != 0ull;
  } else {
    return (D)v;  // modular: the low bytes, two's complement for signed D
  }
}

template <typename S, typename D>
__device__ __forceinline__ D cast_one(S x) {
  if constexpr (std::is_same<S, double>::value) {
    if constexpr (std::is_same<D, float>::value) {
      return __double2float_rn(x);
    } else {
      return (D)x;  // f64 -> f64 (the wrapper admits no other pair)
    }
  } else if constexpr (std::is_floating_point<D>::value) {
    return (D)x;  // cvt.rn from an integer
  } else {
    return low_bytes<D>((unsigned long long)(long long)x);
  }
}

__device__ __forceinline__ int lower_bound(const long long* lut, int C, long long x) {
  int lo = 0, hi = C;  // the count of LUT entries < x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lut[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The shard geometry of one launch: d runs of n elements, the source's and
// the destination's shard s at s * src_stride and s * dst_stride elements.
struct Shards {
  long long n, src_stride, dst_stride;
};

template <int K, typename S, typename D>
__global__ void convert_kernel(const S* __restrict__ src, D* __restrict__ dst, Shards g,
                               long long off, const long long* __restrict__ lut, int C) {
  extern __shared__ long long s_lut[];
  const long long* L = lut;
  if constexpr (K == kIntDictSmem) {
    for (int i = threadIdx.x; i < C; i += blockDim.x) s_lut[i] = lut[i];
    __syncthreads();
    L = s_lut;
  }
  src += (long long)blockIdx.y * g.src_stride;
  dst += (long long)blockIdx.y * g.dst_stride;
  const long long n = g.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const S x = src[i];
    if constexpr (K == kRaw) {
      dst[i] = cast_one<S, D>(x);
    } else if constexpr (K == kNarrow) {
      dst[i] = low_bytes<D>((unsigned long long)(long long)x - (unsigned long long)off);
    } else {
      const int c = lower_bound(L, C, (long long)x);
      dst[i] = low_bytes<D>((unsigned long long)(c < C - 1 ? c : C - 1));
    }
  }
}

template <int K, typename S, typename D>
cudaError_t launch(const void* src, void* dst, int d, Shards g, long long off, const void* lut,
                   int C, cudaStream_t stream) {
  const size_t smem = K == kIntDictSmem ? (size_t)C * sizeof(long long) : 0;
  // The CTAs a one-shard launch of d * n elements would take, shared out
  // over the d shards.
  const int total = grid_for(g.n * d, 8);
  const dim3 grid((unsigned)((total + d - 1) / d), (unsigned)d);
  convert_kernel<K, S, D><<<grid, kThreads, smem, stream>>>(
      (const S*)src, (D*)dst, g, off, (const long long*)lut, C);
  return cudaGetLastError();
}

// Destination dtype codes: 0 bool, 1 uint8, 2 uint16, 3 int32, 4 int64,
// 5 f32, 6 f64 (ops/kernels/__init__.py _CONVERT_CODES).
template <int K, typename S>
cudaError_t dispatch_dst(const void* src, void* dst, int dst_code, int d, Shards g,
                         long long off, const void* lut, int C, cudaStream_t stream) {
  switch (dst_code) {
    case 0: return launch<K, S, bool>(src, dst, d, g, off, lut, C, stream);
    case 1: return launch<K, S, uint8_t>(src, dst, d, g, off, lut, C, stream);
    case 2: return launch<K, S, uint16_t>(src, dst, d, g, off, lut, C, stream);
    case 3: return launch<K, S, int32_t>(src, dst, d, g, off, lut, C, stream);
    case 4: return launch<K, S, long long>(src, dst, d, g, off, lut, C, stream);
    case 5: return launch<K, S, float>(src, dst, d, g, off, lut, C, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// H24. src_code: 0 bool, 3 int32, 4 int64, 6 f64; kind: 0 raw, 1 narrow,
// 2 f32, 3 intdict (the shared-memory variant is chosen here). The wrapper
// admits only the pairs the plans produce: raw casts from bool/int32/int64 to
// bool, uint8, uint16, int32, int64 or f32 and f64 -> f32 or f64; narrow from
// int32/int64 to an integer; f32 from f64; intdict from int64 to uint8,
// uint16 or int32. d shards (1 to 65535) of n elements each, shard s of the
// source at s * src_stride elements and of the destination at s *
// dst_stride.
int px_ring_convert(const void* src, int src_code, void* dst, int dst_code, int kind,
                    long long off, const void* lut, int lut_len, int d, long long n,
                    long long src_stride, long long dst_stride, cudaStream_t stream) {
  if (n <= 0 || d <= 0) return cudaSuccess;
  if (d > 65535) return cudaErrorInvalidValue;
  const Shards g{n, src_stride, dst_stride};
  if (kind == kRaw || kind == kF32) {
    switch (src_code) {
      case 0: return dispatch_dst<kRaw, bool>(src, dst, dst_code, d, g, 0, nullptr, 0, stream);
      case 3:
        return dispatch_dst<kRaw, int32_t>(src, dst, dst_code, d, g, 0, nullptr, 0, stream);
      case 4:
        return dispatch_dst<kRaw, long long>(src, dst, dst_code, d, g, 0, nullptr, 0, stream);
      case 6:
        if (dst_code == 5) {
          return launch<kRaw, double, float>(src, dst, d, g, 0, nullptr, 0, stream);
        }
        if (dst_code == 6) {
          return launch<kRaw, double, double>(src, dst, d, g, 0, nullptr, 0, stream);
        }
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  }
  if (kind == kNarrow) {
    if (dst_code < 1 || dst_code > 4) return cudaErrorInvalidValue;
    switch (src_code) {
      case 3:
        return dispatch_dst<kNarrow, int32_t>(src, dst, dst_code, d, g, off, nullptr, 0, stream);
      case 4:
        return dispatch_dst<kNarrow, long long>(src, dst, dst_code, d, g, off, nullptr, 0,
                                                stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (kind == kIntDict) {
    if (src_code != 4 || dst_code < 1 || dst_code > 3 || lut_len < 1) return cudaErrorInvalidValue;
    if (lut_len <= kSmemLut) {
      return dispatch_dst<kIntDictSmem, long long>(src, dst, dst_code, d, g, 0, lut, lut_len,
                                                   stream);
    }
    return dispatch_dst<kIntDict, long long>(src, dst, dst_code, d, g, 0, lut, lut_len, stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
