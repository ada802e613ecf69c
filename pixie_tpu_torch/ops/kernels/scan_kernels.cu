// Stream compaction of the device scan (H12), built for Hopper (sm_90a) with
// the other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it).
//
// H12 px_scan_compact  replaces the compaction in the body of the
//    while_loop of pixie_tpu/parallel/pipeline.py _build_scan_program
//    (:4126; the body is :4149-4190): a stable sort keyed on ~mask, then
//    dynamic_update_slice of the sorted block at `written`, then
//    written = min(written + count, limit). The predicates and projections
//    before it are torch ops (ops/scan.py).
//
// Operation, for one block of n rows: the rows whose mask is true are
// written, in row order, to out[c][written + rank] for every output column c
// while written + rank < limit (rows at or past the limit are not written:
// no caller reads them), and written becomes min(written + count, limit).
// `written` lives on the device; a launch that finds written >= limit
// returns at once, which reproduces the reference's loop condition
// (written < limit) without a host sync per block.
//
// Design: a single-pass stable compaction with decoupled look-back. Each CTA
// takes the next tile of kTile rows by a ticket (an atomic counter), so a
// tile only ever waits on tiles whose CTAs already run. It counts its
// selected rows (each thread kItems consecutive rows; a block scan gives
// each thread its rank), publishes that count, then walks back over its
// predecessors' published words, adding counts until it meets an inclusive
// prefix, and publishes its own inclusive prefix. Tile 0's prefix starts at
// `written`, read once per CTA before it publishes anything, so no CTA of
// the launch can read the value the last tile writes at the end. A tile
// whose prefix is already at the limit loads no column.
//
// What bounds it on an H100: it must read the mask (n bytes), and the values
// of the rows it writes, and write them: bytes-bound. On the main path the
// first block fills the limit and the launches of every later block return
// after one read of `written`, so those cost launch latency only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxScanCols = 64;
constexpr int kScanThreads = 256;
constexpr int kItems = 8;  // consecutive rows per thread
constexpr int kTile = kScanThreads * kItems;
constexpr int kWarps = kScanThreads / 32;

constexpr unsigned long long kFlagCount = 1ull << 62;      // tile count only
constexpr unsigned long long kFlagInclusive = 2ull << 62;  // inclusive prefix
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

struct ScanCols {
  const void* src[kMaxScanCols];
  void* dst[kMaxScanCols];
  int wide[kMaxScanCols];  // 1: 8-byte elements, 0: 4-byte
  int k;
};

__device__ __forceinline__ void copy_row(const ScanCols& cols, long long row, long long pos) {
  for (int c = 0; c < cols.k; ++c) {
    if (cols.wide[c]) {
      static_cast<long long*>(cols.dst[c])[pos] = static_cast<const long long*>(cols.src[c])[row];
    } else {
      static_cast<int*>(cols.dst[c])[pos] = static_cast<const int*>(cols.src[c])[row];
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
    scan_compact_kernel(const unsigned char* __restrict__ mask, long long n, ScanCols cols,
                        int* written, int limit, unsigned long long* status,
                        unsigned int* ticket) {
  __shared__ int s_tile, s_base;
  __shared__ long long s_excl;
  __shared__ int warp_incl[kWarps];
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(ticket, 1u);
    s_base = *(volatile int*)written;
    __threadfence();  // the read lands before this tile publishes anything
  }
  __syncthreads();
  const int base = s_base;
  if (base >= limit) return;  // full: the whole launch returns
  const int tile = s_tile;

  // The thread's kItems mask bytes, one 8-byte load where aligned and whole.
  const long long row0 = (long long)tile * kTile + (long long)threadIdx.x * kItems;
  unsigned int bits = 0;
  if (row0 + kItems <= n && ((reinterpret_cast<uintptr_t>(mask + row0) & 7) == 0)) {
    const unsigned long long m8 = *reinterpret_cast<const unsigned long long*>(mask + row0);
    for (int j = 0; j < kItems; ++j) bits |= ((m8 >> (8 * j)) & 0xFFull) ? (1u << j) : 0u;
  } else {
    for (int j = 0; j < kItems; ++j) {
      if (row0 + j < n && mask[row0 + j]) bits |= 1u << j;
    }
  }
  const int cnt = __popc(bits);

  // Block-wide inclusive scan of the per-thread counts.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_incl[lane] : 0;
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  const int thread_excl = (warp ? warp_incl[warp - 1] : 0) + incl - cnt;
  const long long tile_count = warp_incl[kWarps - 1];

  // Decoupled look-back for the tile's exclusive prefix.
  if (threadIdx.x == 0) {
    long long excl = base;
    if (tile > 0) {
      atomicExch(&status[tile], kFlagCount | (unsigned long long)tile_count);
      excl = 0;
      int j = tile - 1;
      while (true) {
        const unsigned long long s = *(volatile unsigned long long*)&status[j];
        if (s == 0ull) continue;  // not published yet
        excl += (long long)(s & kValueMask);
        if ((s & ~kValueMask) == kFlagInclusive) break;
        --j;
      }
    }
    atomicExch(&status[tile], kFlagInclusive | (unsigned long long)(excl + tile_count));
    s_excl = excl;
    if (tile == (int)gridDim.x - 1) {
      __threadfence();
      const long long w = excl + tile_count;
      *written = (int)(w < limit ? w : limit);
    }
  }
  __syncthreads();

  long long pos = s_excl + thread_excl;
  if (bits == 0u || pos >= limit) return;
  for (int j = 0; j < kItems && pos < limit; ++j) {
    if (bits & (1u << j)) copy_row(cols, row0 + j, pos++);
  }
}

}  // namespace

extern "C" {

// mask: bool [n]; src[c] / dst[c]: [n] / [cap] columns of 8-byte (wide[c])
// or 4-byte elements; written: int32 [1] on the device; scratch: zeroed
// int64 [ceil(n / 2048) + 1] (tile words, then the ticket).
int px_scan_compact(const void* mask, long long n, const void* const* src, void* const* dst,
                    const int* wide, int k, void* written, int limit, void* scratch,
                    void* stream) {
  if (k < 0 || k > kMaxScanCols) return (int)cudaErrorInvalidValue;
  ScanCols cols{};
  for (int c = 0; c < k; ++c) {
    cols.src[c] = src[c];
    cols.dst[c] = dst[c];
    cols.wide[c] = wide[c];
  }
  cols.k = k;
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  scan_compact_kernel<<<(unsigned int)tiles, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)mask, n, cols, (int*)written, limit, status,
      reinterpret_cast<unsigned int*>(status + tiles));
  return (int)cudaGetLastError();
}

}  // extern "C"
