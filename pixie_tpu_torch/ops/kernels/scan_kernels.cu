// Stream compaction of the device scan and of the join's unmatched rows
// (H12), built for Hopper (sm_90a) with the other kernel sources into one
// shared library that has a plain C interface (ops/kernels/__init__.py builds
// and binds it).
//
// H12 px_scan_compact  replaces the compaction in the body of the
//    while_loop of pixie_tpu/parallel/pipeline.py _build_scan_program
//    (:4126; the body is :4149-4190): a stable sort keyed on ~mask, then
//    dynamic_update_slice of the sorted block at `written`, then
//    written = min(written + count, limit). The predicates and projections
//    before it are torch ops (ops/scan.py). Its index lane replaces
//    pixie_tpu/ops/segment.py:580 compact_unmatched_rows: the sentinel sort
//    of the row indices, int32 [cap], `n` past the count.
//
// Operation, for one block of n rows: the rows whose mask is true are
// written, in row order, to out[c][written + rank] for every output column c
// while written + rank < limit (rows at or past the limit are not written:
// no caller reads them), and written becomes min(written + count, limit).
// `written` lives on the device; a launch that finds written >= limit
// returns at once, which reproduces the reference's loop condition
// (written < limit) without a host sync per block. The index lane writes
// each selected row's own index (no source column, no `written`: it starts
// at 0) and `pad` to every slot from the count to the limit.
//
// What bounds it on an H100: it must read the mask (n bytes), and the values
// of the rows it writes, and write them: bytes-bound. On the main path the
// first block fills the limit and the launches of every later block return
// after one read of `written`, so those cost launch latency only.
//
// Design. The first design (PR 3) chained 2048-row tiles by a decoupled
// look-back: thread 0 of each tile waited for its predecessors one L2 round
// trip after another, every tile of a block read its mask even when the
// limit filled in the first five, the wrapper zeroed a look-back scratch
// before every launch, each thread copied its own 8 consecutive rows (a
// warp's stores in up to 32 spans), and the join read its row indices from
// a torch.arange and took its padding from a torch.full. Now:
//   1. a cooperative launch of coarse shares, about two CTAs an SM (every
//      CTA resident), each share a multiple of 16 rows; a CTA counts its
//      share's mask with 16-byte loads, four in flight a thread, and
//      __vcmpne4 + a multiply packing each load's 16 bytes into bits (the
//      bits of its first two copy rounds stay in registers);
//   2. it publishes its count in a status word tagged with the launch's
//      epoch (a per-stream buffer the wrapper keeps and never zeroes: a word
//      of an earlier launch carries an earlier epoch), then reads the words
//      of every CTA before it at once (its threads spread over them),
//      waiting only for words of this epoch: its exclusive prefix, with no
//      chain of waits and no scratch to reset (CTA 0 waits for none);
//   3. a share whose prefix is already at the limit touches no column;
//      the others compact each 8192-row chunk's selected row indices in
//      shared memory (a block scan of the threads' counts, 32 rows a
//      thread) and copy them, each thread gathering 4 rows of up to 4
//      columns before it stores them, neighbouring threads on neighbouring
//      slots;
//   4. the last CTA's prefix and count are the total: it sets `written`
//      (every other CTA has published, so has read it); the index lane
//      stores the indices themselves, and each CTA, after its copy, reads
//      the later CTAs' words too and writes its slice of the padding.
// An optional probe takes CTA 0's clock64 at the start and after the count,
// the wait for its prefix, the copy and the padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxScanCols = 64;
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kGroup = 16;                        // rows of one 16-byte mask load
constexpr int kThreadRows = 2 * kGroup;           // a thread's rows of a copy round
constexpr int kChunk = kScanThreads * kThreadRows;  // rows a copy round stages
constexpr int kUnroll = 4;                        // mask loads in flight a thread
constexpr int kKeep = 2;  // chunks whose bits a thread keeps from the count for the copy
static_assert(kKeep == 2, "the copy takes kept[0] or kept[1]");
constexpr int kRowBatch = 4;                      // rows a thread gathers at once
constexpr int kColBatch = 4;                      // columns gathered at once

struct ScanArgs {
  const unsigned char* mask;
  long long n;
  const void* src[kMaxScanCols];
  void* dst[kMaxScanCols];
  int wide[kMaxScanCols];  // 1: 8-byte elements, 0: 4-byte
  int k;
  int* written;      // null in the index lane (the count starts at 0)
  int limit;
  int* index_out;    // the index lane's output, else null
  int pad;           // written past the count in the index lane
  long long share;   // rows a CTA, a multiple of kGroup
  unsigned long long* words;  // a status word a CTA: epoch << 32 | count
  unsigned int epoch;
  int vec;           // the mask is 16-byte aligned
  long long* probe;
};

__device__ __forceinline__ void stamp(const ScanArgs& a, int k) {
  if (a.probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) a.probe[k] = clock64();
}

// Bit j set iff byte j of w is not zero (bits 0..3).
__device__ __forceinline__ unsigned int nz4(unsigned int w) {
  return ((__vcmpne4(w, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// The selection bits of rows [r, r + 16) (clipped to hi), bit j for row r + j.
__device__ __forceinline__ unsigned int group_bits(const ScanArgs& a, long long r, long long hi) {
  if (r >= hi) return 0u;
  if (a.vec && r + kGroup <= hi) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(a.mask + r));
    return nz4(q.x) | (nz4(q.y) << 4) | (nz4(q.z) << 8) | (nz4(q.w) << 12);
  }
  unsigned int bits = 0;
  for (int j = 0; j < kGroup && r + j < hi; ++j) bits |= (a.mask[r + j] != 0) << j;
  return bits;
}

// The selection bits of a thread's kThreadRows rows from r (clipped to hi).
__device__ __forceinline__ unsigned int thread_bits(const ScanArgs& a, long long r, long long hi) {
  return group_bits(a, r, hi) | (group_bits(a, r + kGroup, hi) << kGroup);
}

// Block-wide sum of v (every thread gets it); red holds kScanWarps values.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int i = 0; i < kScanWarps; ++i) s += red[i];
  return s;
}

// The sum of the counts the CTAs j0 <= j < j1 published in this launch
// (their words of this epoch; the threads wait on them side by side).
__device__ __forceinline__ long long published(const ScanArgs& a, int j0, int j1,
                                               long long* red) {
  long long sum = 0;
  for (int j = j0 + threadIdx.x; j < j1; j += kScanThreads) {
    unsigned long long w;
    while (((w = *(volatile unsigned long long*)&a.words[j]) >> 32) != a.epoch) __nanosleep(20);
    sum += (long long)(w & 0xffffffffull);
  }
  return block_sum(sum, red);
}

// Copies the rows s_rows[0, take) of every column to dst[c][pos + i]: each
// thread gathers kRowBatch rows of up to kColBatch columns before it
// stores them, neighbouring threads on neighbouring slots.
__device__ __forceinline__ void copy_rows(const ScanArgs& a, const int* s_rows, int take,
                                          long long pos) {
  for (int c0 = 0; c0 < a.k; c0 += kColBatch) {
    for (int i0 = threadIdx.x; i0 < take; i0 += kScanThreads * kRowBatch) {
      int rows[kRowBatch];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        const int i = i0 + u * kScanThreads;
        rows[u] = i < take ? s_rows[i] : -1;
      }
      long long v[kColBatch][kRowBatch];
#pragma unroll
      for (int cc = 0; cc < kColBatch; ++cc) {
        const int col = c0 + cc;
        if (col >= a.k) continue;
        const bool wide = a.wide[col] != 0;
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          if (rows[u] < 0) continue;
          v[cc][u] = wide ? __ldg(static_cast<const long long*>(a.src[col]) + rows[u])
                          : (long long)__ldg(static_cast<const int*>(a.src[col]) + rows[u]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < kColBatch; ++cc) {
        const int col = c0 + cc;
        if (col >= a.k) continue;
        const bool wide = a.wide[col] != 0;
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          if (rows[u] < 0) continue;
          const long long slot = pos + i0 + u * kScanThreads;
          if (wide) {
            static_cast<long long*>(a.dst[col])[slot] = v[cc][u];
          } else {
            static_cast<int*>(a.dst[col])[slot] = (int)v[cc][u];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kScanThreads) scan_compact_kernel(const ScanArgs a) {
  __shared__ int s_rows[kChunk];
  __shared__ long long s_red[kScanWarps];
  __shared__ int s_warp[kScanWarps];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int last = (int)gridDim.x - 1;
  stamp(a, 0);
  if (threadIdx.x == 0) {
    s_base = a.written != nullptr ? *(volatile int*)a.written : 0;
    __threadfence();  // the read lands before this CTA publishes anything
  }
  __syncthreads();
  const int base = s_base;
  // Only the last CTA writes `written`, once every other CTA has published
  // (so has read it): every CTA sees the same value, and a launch that
  // finds the limit reached returns together.
  if (base >= a.limit) return;
  const long long lo = (long long)blockIdx.x * a.share;
  const long long hi = lo + a.share < a.n ? lo + a.share : a.n;

  // 1. The share's count, published with this launch's epoch. The bits of
  // the first kKeep chunks stay in registers for the copy.
  unsigned int kept[kKeep];
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    kept[k] = thread_bits(a, lo + (long long)k * kChunk + (long long)threadIdx.x * kThreadRows, hi);
  }
  long long cnt = 0;
#pragma unroll
  for (int k = 0; k < kKeep; ++k) cnt += __popc(kept[k]);
  for (long long r0 = lo + (long long)kKeep * kChunk + (long long)threadIdx.x * kGroup; r0 < hi;
       r0 += (long long)kScanThreads * kGroup * kUnroll) {
    unsigned int bits[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bits[u] = group_bits(a, r0 + (long long)u * kScanThreads * kGroup, hi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cnt += __popc(bits[u]);
  }
  const long long count = block_sum(cnt, s_red);
  if (threadIdx.x == 0) {
    atomicExch(&a.words[blockIdx.x],
               ((unsigned long long)a.epoch << 32) | (unsigned long long)count);
  }
  stamp(a, 1);

  // 2. The exclusive prefix: the counts of the CTAs before this one.
  const long long excl = published(a, 0, blockIdx.x, s_red);
  stamp(a, 2);

  // 3. The copy, a chunk of kChunk rows (kThreadRows a thread) at a time.
  long long pos = base + excl;
  int ci = 0;
  for (long long c0 = lo; c0 < hi && pos < a.limit; c0 += kChunk, ++ci) {
    const long long r = c0 + (long long)threadIdx.x * kThreadRows;
    const unsigned int bits = ci == 0 ? kept[0] : ci == 1 ? kept[1] : thread_bits(a, r, hi);
    const int c = __popc(bits);
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
    for (int i = 0; i < kScanWarps; ++i) {
      before += i < warp ? s_warp[i] : 0;
      chunk += s_warp[i];
    }
    int o = before + incl - c;
    for (unsigned int b = bits; b; b &= b - 1) s_rows[o++] = (int)(r + __ffs(b) - 1);
    __syncthreads();
    const long long room = a.limit - pos;
    const int take = (int)(chunk < room ? chunk : room);
    if (a.index_out != nullptr) {
      for (int i = threadIdx.x; i < take; i += kScanThreads) a.index_out[pos + i] = s_rows[i];
    } else {
      copy_rows(a, s_rows, take, pos);
    }
    pos += chunk;
    __syncthreads();  // s_rows and s_warp are refilled next round
  }
  stamp(a, 3);

  // 4. The total: the last CTA's prefix and count; in the index lane every
  // CTA also waits for the later CTAs' counts and writes its slice of the
  // padding [count, limit).
  if (a.index_out != nullptr) {
    const long long total =
        excl + count + (blockIdx.x < last ? published(a, blockIdx.x + 1, last + 1, s_red) : 0);
    const long long filled = total < a.limit ? total : a.limit;
    const long long per = (a.limit - filled + gridDim.x - 1) / gridDim.x;
    const long long p0 = filled + (long long)blockIdx.x * per;
    const long long p1 = p0 + per < a.limit ? p0 + per : a.limit;
    for (long long p = p0 + threadIdx.x; p < p1; p += kScanThreads) a.index_out[p] = a.pad;
  } else if (blockIdx.x == last && threadIdx.x == 0) {
    const long long w = base + excl + count;
    *a.written = (int)(w < a.limit ? w : a.limit);
  }
  stamp(a, 4);
}

}  // namespace

extern "C" {

// mask: bool [n] (any non-zero byte selects); src[c] / dst[c]: [n] / [limit]
// columns of 8-byte (wide[c]) or 4-byte elements (k may be 0), or k = 0 and index_out:
// int32 [limit] (the index lane: no written, pad past the count); written:
// int32 [1] on the device or null; grid CTAs of `share` rows (a multiple of
// 16, grid * share >= n > (grid - 1) * share); words: grid status words of
// a buffer no launch on another stream uses, none holding `epoch` (> 0);
// probe: null or int64 [5]. A cooperative launch: fails if the grid cannot
// be resident at once.
int px_scan_compact(const void* mask, long long n, const void* const* src, void* const* dst,
                    const int* wide, int k, void* written, int limit, void* index_out, int pad,
                    int grid, long long share, void* words, unsigned int epoch, void* probe,
                    void* stream) {
  if (k < 0 || k > kMaxScanCols || (index_out != nullptr && k > 0) || n < 1 ||
      n >= (1ll << 31) || limit < 0 || grid < 1 || share < 1 || share % kGroup != 0 ||
      (long long)grid * share < n || (long long)(grid - 1) * share >= n || epoch == 0 ||
      (index_out != nullptr) == (written != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_compact_kernel, kScanThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  if (grid > per_sm * px::num_sms()) return (int)cudaErrorCooperativeLaunchTooLarge;
  ScanArgs a = {};
  a.mask = (const unsigned char*)mask;
  a.n = n;
  for (int c = 0; c < k; ++c) {
    a.src[c] = src[c];
    a.dst[c] = dst[c];
    a.wide[c] = wide[c];
  }
  a.k = k;
  a.written = (int*)written;
  a.limit = limit;
  a.index_out = (int*)index_out;
  a.pad = pad;
  a.share = share;
  a.words = (unsigned long long*)words;
  a.epoch = epoch;
  a.vec = (uintptr_t)mask % 16 == 0;
  a.probe = (long long*)probe;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)scan_compact_kernel, dim3(grid), dim3(kScanThreads), params, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
