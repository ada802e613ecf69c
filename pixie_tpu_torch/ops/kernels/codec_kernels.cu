// Device decode of the staging codec (ops/codec.py), built for Hopper
// (sm_90a) with the other kernel sources into one shared library that has a
// plain C interface (ops/kernels/__init__.py builds and binds it). Each
// launches on the CUDA runtime's current device and the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// H18 px_codec_rle_decode    replaces the RLE branch of
//    pixie_tpu/ops/codec.py _decoder (:383-393): out[s, i] =
//    values[s, min(searchsorted(ends[s], i, right), R - 1)].
// H19 px_codec_delta_decode  replaces the delta branch of _decoder
//    (:398-414): d64 = delta + off, zeroed at row 0 and at rows >= rows[s];
//    v = bases[s] + inclusive_cumsum(d64), zeroed at rows >= rows[s], cast
//    to the block dtype.
//
// Both copy bits: H18 moves each value as an unsigned integer of its width
// (NaN payloads and signed zeros survive), H19 adds in unsigned 64-bit
// arithmetic (wrapping mod 2^64, as XLA's int64 adds do, so the result is
// exact whatever the order of the adds) and stores the low bytes of each
// sum, as astype does.
//
// What bounds them on an H100: both read their payload once and write the
// block once, so bytes bound them (a 2^23-row int64 block is 64 MB, ~20 us
// at 3.35 TB/s). H18 is one thread per output row with a binary search over
// its shard's run ends (R int32, ~16 KB at 4096 runs, served from L1/L2).
// H19 is a single-pass scan with decoupled look-back, the pattern of H12
// (scan_kernels.cu): each CTA takes the next tile by a ticket, so a tile
// only waits on tiles whose CTAs already run; it publishes its tile sum
// (flag 1) and then its inclusive prefix (flag 2). The sums are 64-bit, so
// a flag word and two value words per tile replace H12's packed status
// word: a value is written, then fenced, then its flag set; a reader fences
// after it sees the flag. Tiles never look back across a shard: the first
// tile of each shard publishes its inclusive prefix at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using px::grid_for;
using px::kThreads;

// ---------------------------------------------------------------- H18
template <typename T>
__global__ void rle_decode_kernel(const T* __restrict__ values, const int* __restrict__ ends,
                                  int R, long long L, long long total, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long s = i / L;
    const int r = (int)(i - s * L);
    const int* e = ends + s * R;
    int lo = 0, hi = R;  // the count of ends <= r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(&e[mid]) <= r) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[i] = values[s * R + (lo < R - 1 ? lo : R - 1)];
  }
}

template <typename T>
cudaError_t launch_rle(const void* values, const void* ends, int d, int R, long long L, void* out,
                       cudaStream_t stream) {
  const long long total = (long long)d * L;
  rle_decode_kernel<T><<<grid_for(total, 8), kThreads, 0, stream>>>(
      (const T*)values, (const int*)ends, R, L, total, (T*)out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- H19
constexpr int kScanThreads = 256;
constexpr int kItems = 8;  // consecutive rows per thread
constexpr int kTile = kScanThreads * kItems;
constexpr int kWarps = kScanThreads / 32;

// Delta kinds of the wrapper: 0 nibbles (uint8, low first), 1 uint8,
// 2 uint16, 3 int8, 4 int16, 5 int32.
template <int kKind>
__device__ __forceinline__ unsigned long long load_delta(const void* deltas, long long i) {
  if (kKind == 0) {
    const unsigned char byte = static_cast<const unsigned char*>(deltas)[i >> 1];
    return (i & 1) ? (unsigned long long)(byte >> 4) : (unsigned long long)(byte & 0xF);
  } else if (kKind == 1) {
    return (unsigned long long)static_cast<const uint8_t*>(deltas)[i];
  } else if (kKind == 2) {
    return (unsigned long long)static_cast<const uint16_t*>(deltas)[i];
  } else if (kKind == 3) {
    return (unsigned long long)(long long)static_cast<const int8_t*>(deltas)[i];
  } else if (kKind == 4) {
    return (unsigned long long)(long long)static_cast<const int16_t*>(deltas)[i];
  } else {
    return (unsigned long long)(long long)static_cast<const int32_t*>(deltas)[i];
  }
}

template <int kKind, typename OT>
__global__ void __launch_bounds__(kScanThreads)
    delta_decode_kernel(const long long* __restrict__ bases, const void* __restrict__ deltas,
                        long long dstride, const int* __restrict__ rows, long long off,
                        long long L, int tiles_per_shard, OT* __restrict__ out,
                        unsigned long long* flags, unsigned long long* agg,
                        unsigned long long* incl, unsigned int* ticket) {
  __shared__ int s_tile;
  __shared__ unsigned long long s_excl;
  __shared__ unsigned long long warp_incl[kWarps];
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int s = tile / tiles_per_shard;
  const int k = tile - s * tiles_per_shard;
  const long long r = rows[s];
  const unsigned char* dbase =
      static_cast<const unsigned char*>(deltas) +
      (kKind == 0 ? s * dstride
                  : s * dstride * (long long)(kKind == 2 || kKind == 4 ? 2 : kKind == 5 ? 4 : 1));

  // The thread's kItems rows: d64 and their running (inclusive) sums.
  const long long row0 = (long long)k * kTile + (long long)threadIdx.x * kItems;
  unsigned long long run[kItems];
  unsigned long long acc = 0ull;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = row0 + j;
    unsigned long long d64 = 0ull;
    if (i > 0 && i < r && i < L) d64 = load_delta<kKind>(dbase, i) + (unsigned long long)off;
    acc += d64;
    run[j] = acc;
  }

  // Block-wide inclusive scan of the per-thread totals.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long tincl = acc;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, tincl, o);
    if (lane >= o) tincl += y;
  }
  if (lane == 31) warp_incl[warp] = tincl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < kWarps ? warp_incl[lane] : 0ull;
    for (int o = 1; o < kWarps; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  const unsigned long long thread_excl = (warp ? warp_incl[warp - 1] : 0ull) + tincl - acc;
  const unsigned long long tile_sum = warp_incl[kWarps - 1];

  // Decoupled look-back for the tile's exclusive prefix within its shard.
  if (threadIdx.x == 0) {
    unsigned long long excl = 0ull;
    if (k > 0) {
      *(volatile unsigned long long*)&agg[tile] = tile_sum;
      __threadfence();
      atomicExch(&flags[tile], 1ull);
      int j = tile - 1;
      while (true) {
        const unsigned long long f = *(volatile unsigned long long*)&flags[j];
        if (f == 0ull) continue;  // not published yet
        __threadfence();
        if (f == 2ull) {
          excl += *(volatile unsigned long long*)&incl[j];
          break;
        }
        excl += *(volatile unsigned long long*)&agg[j];
        --j;
      }
    }
    *(volatile unsigned long long*)&incl[tile] = excl + tile_sum;
    __threadfence();
    atomicExch(&flags[tile], 2ull);
    s_excl = excl;
  }
  __syncthreads();

  const unsigned long long base = (unsigned long long)bases[s] + s_excl + thread_excl;
  OT* o = out + (long long)s * L;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = row0 + j;
    if (i < L) o[i] = (OT)(i < r ? base + run[j] : 0ull);
  }
}

template <int kKind>
cudaError_t launch_delta_kind(const void* bases, const void* deltas, long long dstride,
                              const void* rows, long long off, int d, long long L, int out_size,
                              void* out, void* scratch, cudaStream_t stream) {
  const int tps = (int)((L + kTile - 1) / kTile);
  const long long tiles = (long long)d * tps;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  unsigned long long* flags = words;
  unsigned long long* agg = words + tiles;
  unsigned long long* incl = words + 2 * tiles;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(words + 3 * tiles);
  const dim3 grid((unsigned int)tiles);
#define PX_DELTA(OT)                                                                      \
  delta_decode_kernel<kKind, OT><<<grid, kScanThreads, 0, stream>>>(                      \
      (const long long*)bases, deltas, dstride, (const int*)rows, off, L, tps, (OT*)out, \
      flags, agg, incl, ticket)
  switch (out_size) {
    case 1: PX_DELTA(uint8_t); break;
    case 2: PX_DELTA(uint16_t); break;
    case 4: PX_DELTA(uint32_t); break;
    case 8: PX_DELTA(unsigned long long); break;
    default: return cudaErrorInvalidValue;
  }
#undef PX_DELTA
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// values: [d, R] elements of `elem_size` bytes; ends: int32 [d, R];
// out: [d, L] elements of `elem_size` bytes.
int px_codec_rle_decode(const void* values, const void* ends, int d, int R, long long L,
                        int elem_size, void* out, void* stream) {
  if (d <= 0 || R <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (elem_size) {
    case 1: return (int)launch_rle<uint8_t>(values, ends, d, R, L, out, st);
    case 2: return (int)launch_rle<uint16_t>(values, ends, d, R, L, out, st);
    case 4: return (int)launch_rle<uint32_t>(values, ends, d, R, L, out, st);
    case 8: return (int)launch_rle<unsigned long long>(values, ends, d, R, L, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bases: int64 [d]; deltas: [d, dstride] of `kind` (0 nibbles: dstride =
// ceil(L / 2) bytes); rows: int32 [d]; out: [d, L] elements of `out_size`
// bytes; scratch: zeroed int64 [3 * d * ceil(L / 2048) + 1] (flags, tile
// sums, inclusive prefixes, then the ticket).
int px_codec_delta_decode(const void* bases, const void* deltas, long long dstride, int kind,
                          const void* rows, long long off, int d, long long L, int out_size,
                          void* out, void* scratch, void* stream) {
  if (d <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: return (int)launch_delta_kind<0>(bases, deltas, dstride, rows, off, d, L, out_size, out, scratch, st);
    case 1: return (int)launch_delta_kind<1>(bases, deltas, dstride, rows, off, d, L, out_size, out, scratch, st);
    case 2: return (int)launch_delta_kind<2>(bases, deltas, dstride, rows, off, d, L, out_size, out, scratch, st);
    case 3: return (int)launch_delta_kind<3>(bases, deltas, dstride, rows, off, d, L, out_size, out, scratch, st);
    case 4: return (int)launch_delta_kind<4>(bases, deltas, dstride, rows, off, d, L, out_size, out, scratch, st);
    case 5: return (int)launch_delta_kind<5>(bases, deltas, dstride, rows, off, d, L, out_size, out, scratch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
