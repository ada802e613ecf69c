// Device decode of the staging codec (ops/codec.py), built for Hopper
// (sm_90a) with the other kernel sources into one shared library that has a
// plain C interface (ops/kernels/__init__.py builds and binds it). Each
// launches on the CUDA runtime's current device and the caller's stream,
// allocates nothing, and returns the cudaError_t of its launches.
//
// H18 px_codec_rle_decode    replaces the RLE branch of
//    pixie_tpu/ops/codec.py _decoder (:383-393): out[s, i] =
//    values[s, min(searchsorted(ends[s], i, right), R - 1)].
// H19 px_codec_delta_decode  replaces the delta branch of _decoder
//    (:398-414): d64 = delta + off, zeroed at row 0 and at rows >= rows[s];
//    v = bases[s] + inclusive_cumsum(d64), zeroed at rows >= rows[s], cast
//    to the block dtype. It enqueues three grids (below); the wrapper
//    counts the call as one launch.
//
// Both copy bits: H18 moves each value as an unsigned integer of its width
// (NaN payloads and signed zeros survive), H19 adds in unsigned 64-bit
// arithmetic (wrapping mod 2^64, as XLA's int64 adds do, so the result is
// exact whatever the order of the adds) and stores the low bytes of each
// sum, as astype does.
//
// What bounds them on an H100: both read their payload once and write the
// block once, so bytes bound them (a 2^23-row int64 block is 64 MB, ~20 us
// at 3.35 TB/s).
//
// H18's first design (PR 7) gave each output row a thread, a 64-bit
// division i / L and a binary search over its shard's run ends: 12
// dependent loads a row at 4096 runs, 22 at the codec's short-run limit
// (runs_cap up to about L / 2.1 for 8-byte blocks, where `ends` is 16 MB
// and leaves the L1), and a scalar store of 1-8 bytes. 0.081-0.089 ms at
// 2^23 rows and 4096 runs, 17x its bound. Now a CTA takes a tile of
// consecutive rows of one shard (4096 rows of 1- and 2-byte blocks, 2048 of
// 4- and 8-byte ones; a 2-D grid, no division): warps 0 and 1 find the runs
// of its first and last row at once by a 32-ary search (ballots over 32
// ends a round: 3 rounds at 4096 runs, 5 at 2^22; with 256 runs or fewer
// the CTA takes them all and searches nothing), the CTA stages those runs'
// ends and values in shared memory with coalesced loads (at most the
// tile's rows + 1 of them), and each thread expands 16-byte slots of the
// output (aligned to the address, so a shard that starts off 16 bytes
// writes its edge rows one by one): a binary search of the staged ends
// finds the slot's first run; a slot inside one run is that run's value
// repeated, else a walk with the next end in a register; the slot goes out
// as one vector store, neighbouring threads on neighbouring slots (a shard
// of 256 rows or fewer: a row a thread, each searched). Runs of no
// rows (repeated ends) inside a tile can outnumber the staged window; a row
// past it is searched in global memory, and a row past the last end takes
// run R - 1.
//
// H19's first design (a single-pass scan with decoupled look-back over
// 2048-row tiles) took 0.268 ms at 2^23 nibble rows whatever the output
// width: thread 0 of each tile walked its predecessors' flags one at a time
// (a serialized L2 round trip a tile, ~65 ns x 4096 tiles), each thread's 8
// consecutive rows made every warp store touch 32 separate spans, and the
// wrapper zeroed 3 words a tile on every call. Now it is a reduce-then-scan
// in three grids on the caller's stream, with nothing to spin on and no
// zeroed scratch:
//   1. a CTA a 4096-row tile sums its d64 and writes the sum (every tile
//      sum is written, so the scratch needs no reset);
//   2. one CTA a shard scans its tile sums in place into exclusive
//      prefixes plus the shard's base;
//   3. a CTA a tile re-reads its payload (0.5 B a nibble row: ~1.3 us for
//      2^23 rows), scans it in registers (32 rows a thread for nibbles, one
//      uint4 of payload; 16 for the other kinds) and across the CTA, adds
//      its prefix, stages the low bytes of each sum in shared memory (a pad
//      word every 32, so the threads' strided writes miss each other's
//      banks) and writes the tile out in 16-byte vectors that neighbouring
//      threads place side by side.
// A shard whose payload or block is not 16-byte aligned (a short odd shard
// of a multi-shard window) is read or written row by row.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- H18
constexpr int kRleThreads = 256;

template <typename T>
struct RleTile {
  static constexpr int kRows = sizeof(T) <= 2 ? 4096 : 2048;  // rows a CTA
  static constexpr int kCap = kRows + 1;  // staged runs: the tile's, at most
  static constexpr int kVec = 16 / (int)sizeof(T);  // rows of a 16-byte slot
};

// The count of e[lo, hi) at or below x (e ascending), by a 32-ary search:
// each round 32 lanes test evenly spaced ends and a ballot keeps the span
// between the last that passes and the first that fails. Every lane of
// the warp calls it and gets the count.
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ e, int lo, int hi,
                                                long long x) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const long long p = (long long)lo + (long long)(lane + 1) * step - 1;
    const bool le = p < hi && (long long)__ldg(e + p) <= x;
    const int m = __popc(__ballot_sync(0xffffffffu, le));
    const long long top = (long long)lo + (long long)(m + 1) * step - 1;
    hi = top < hi ? (int)top : hi;
    lo += m * step;
  }
  return lo;
}

// The count of e[0, w) at or below x (e ascending, in shared memory).
__device__ __forceinline__ int shared_upper_bound(const int* e, int w, int x) {
  int lo = 0, hi = w;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The value of row r whose count of staged ends reached w: past the last
// end (run R - 1), or past a window that repeated ends cut short (searched
// in global memory). Rare, so kept out of line.
template <typename T>
__device__ __noinline__ T rle_beyond(const T* __restrict__ v, const int* __restrict__ e, int R,
                                     int from, int r) {
  int lo = from, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(e + mid) <= r) lo = mid + 1; else hi = mid;
  }
  return __ldg(v + (lo < R ? lo : R - 1));
}

template <typename T>
__global__ void __launch_bounds__(kRleThreads)
    rle_decode_kernel(const T* __restrict__ values, const int* __restrict__ ends, int R, int L,
                      T* __restrict__ out, long long* probe) {
  using Tile = RleTile<T>;
  __shared__ int s_end[Tile::kCap];
  __shared__ T s_val[Tile::kCap];
  __shared__ int s_j[2];
  const bool probing = probe != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  if (probing) probe[0] = clock64();
  const int s = blockIdx.y;
  const int a = blockIdx.x * Tile::kRows;
  const int b = a + Tile::kRows < L ? a + Tile::kRows : L;
  const int* e = ends + (long long)s * R;
  const T* v = values + (long long)s * R;
  const int warp = threadIdx.x >> 5;
  // The runs of the tile's first and last row, j0 and j1 (R: past every
  // end); with a run for each thread or fewer the CTA stages them all.
  if (R > kRleThreads && warp < 2) {
    const int j = warp_upper_bound(e, 0, R, warp == 0 ? a : b - 1);
    if ((threadIdx.x & 31) == 0) s_j[warp] = j;
  }
  __syncthreads();
  if (probing) probe[1] = clock64();
  const int j0 = R > kRleThreads ? s_j[0] : 0;
  const int j1 = R > kRleThreads ? s_j[1] : R;
  const int need = (j1 < R ? j1 + 1 : R) - j0;  // runs j0 .. min(j1, R - 1)
  const int w = need < Tile::kCap ? need : Tile::kCap;
  for (int i = threadIdx.x; i < w; i += kRleThreads) {
    s_end[i] = __ldg(e + j0 + i);
    s_val[i] = __ldg(v + j0 + i);
  }
  __syncthreads();
  if (probing) probe[2] = clock64();
  const bool clamp = j0 + w >= R;
  const int from = clamp ? R : j0 + w;  // where rle_beyond searches
  T* shard = out + (long long)s * L;
  if (L <= kRleThreads) {  // a shard of a row a thread or fewer: a search a row
    if ((int)threadIdx.x < L) {
      const int c = shared_upper_bound(s_end, w, threadIdx.x);
      shard[threadIdx.x] = c < w ? s_val[c] : rle_beyond(v, e, R, from, threadIdx.x);
    }
    if (probing) probe[3] = clock64();
    return;
  }
  // 16-byte slots of the address space that hold the tile's rows [a, b),
  // neighbouring threads on neighbouring slots. A binary search of the
  // staged ends finds a slot's first run; a slot inside one run takes its
  // value at once, else a walk with the next end in a register. A count
  // that reaches w takes rle_beyond.
  const long long base = (long long)reinterpret_cast<uintptr_t>(shard);
  const long long q0 = (base + (long long)a * (long long)sizeof(T)) / 16;
  const long long q1 = (base + (long long)b * (long long)sizeof(T) - 1) / 16;
  for (long long q = q0 + threadIdx.x; q <= q1; q += kRleThreads) {
    // The slot's rows: first (before a where the slot starts before the
    // tile, or before the shard), then the next kVec - 1.
    const int first = (int)((q * 16 - base) / (long long)sizeof(T));
    const int r0 = first > a ? first : a;
    const int r1 = first + Tile::kVec < b ? first + Tile::kVec : b;
    int c = shared_upper_bound(s_end, w, r0);
    int next = c < w ? s_end[c] : INT_MAX;  // the row where run c ends
    T cur = c < w ? s_val[c] : rle_beyond(v, e, R, from, r0);
    if (first >= a && first + Tile::kVec <= b) {
      union { uint4 u; T t[Tile::kVec]; } slot;
      if (next >= first + Tile::kVec && (c < w || clamp)) {  // one run holds the slot
#pragma unroll
        for (int k = 0; k < Tile::kVec; ++k) slot.t[k] = cur;
      } else {
#pragma unroll
        for (int k = 0; k < Tile::kVec; ++k) {
          const int r = first + k;
          if (r >= next || (c >= w && !clamp)) {
            while (r >= next) next = ++c < w ? s_end[c] : INT_MAX;
            cur = c < w ? s_val[c] : rle_beyond(v, e, R, from, r);
          }
          slot.t[k] = cur;
        }
      }
      *reinterpret_cast<uint4*>(shard + first) = slot.u;
    } else {  // the slot holds rows outside the tile: its own rows one by one
      for (int r = r0; r < r1; ++r) {
        if (r >= next || (c >= w && !clamp)) {
          while (r >= next) next = ++c < w ? s_end[c] : INT_MAX;
          cur = c < w ? s_val[c] : rle_beyond(v, e, R, from, r);
        }
        shard[r] = cur;
      }
    }
  }
  if (probing) probe[3] = clock64();
}

template <typename T>
cudaError_t launch_rle(const void* values, const void* ends, int d, int R, long long L, void* out,
                       void* probe, cudaStream_t stream) {
  if (L >= (1ll << 31) || d > 65535) return cudaErrorInvalidValue;
  const long long tiles = (L + RleTile<T>::kRows - 1) / RleTile<T>::kRows;
  rle_decode_kernel<T><<<dim3((unsigned int)tiles, (unsigned int)d), kRleThreads, 0, stream>>>(
      (const T*)values, (const int*)ends, R, (int)L, (T*)out, (long long*)probe);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- H19
// A tile is kDeltaTile rows of one shard. Each thread owns kRows
// consecutive rows: 32 for nibbles (one uint4 of payload), 16 for the
// other kinds (one to four uint4s).
constexpr int kDeltaTile = 4096;

template <int kKind>
struct DeltaCfg {
  static constexpr int kRows = kKind == 0 ? 32 : 16;
  static constexpr int kThreads = kDeltaTile / kRows;
  static constexpr int kWarps = kThreads / 32;
  // Payload bytes of one row (nibbles: 0, two rows a byte).
  static constexpr int kElem = kKind == 0 ? 0 : (kKind == 2 || kKind == 4) ? 2 : kKind == 5 ? 4 : 1;
  static constexpr int kBytes = kKind == 0 ? kRows / 2 : kRows * kElem;  // a thread's payload
};

// Delta kinds of the wrapper: 0 nibbles (uint8, low first), 1 uint8,
// 2 uint16, 3 int8, 4 int16, 5 int32.
template <int kKind>
__device__ __forceinline__ unsigned long long load_delta(const unsigned char* dbase, long long i) {
  if (kKind == 0) {
    const unsigned char byte = dbase[i >> 1];
    return (i & 1) ? (unsigned long long)(byte >> 4) : (unsigned long long)(byte & 0xF);
  } else if (kKind == 1) {
    return (unsigned long long)dbase[i];
  } else if (kKind == 2) {
    return (unsigned long long)reinterpret_cast<const uint16_t*>(dbase)[i];
  } else if (kKind == 3) {
    return (unsigned long long)(long long)reinterpret_cast<const int8_t*>(dbase)[i];
  } else if (kKind == 4) {
    return (unsigned long long)(long long)reinterpret_cast<const int16_t*>(dbase)[i];
  } else {
    return (unsigned long long)(long long)reinterpret_cast<const int32_t*>(dbase)[i];
  }
}

__device__ __forceinline__ unsigned int word_of(const uint4* v, int w) {
  const uint4 q = v[w >> 2];
  return (w & 3) == 0 ? q.x : (w & 3) == 1 ? q.y : (w & 3) == 2 ? q.z : q.w;
}

// Row j of a thread's payload words, sign-extended by kind.
template <int kKind>
__device__ __forceinline__ unsigned long long delta_of(const uint4* v, int j) {
  if (kKind == 0) return (word_of(v, j >> 3) >> ((j & 7) * 4)) & 0xFu;
  if (kKind == 1) return (word_of(v, j >> 2) >> ((j & 3) * 8)) & 0xFFu;
  if (kKind == 3) return (unsigned long long)(long long)(int8_t)(word_of(v, j >> 2) >> ((j & 3) * 8));
  if (kKind == 2) return (word_of(v, j >> 1) >> ((j & 1) * 16)) & 0xFFFFu;
  if (kKind == 4) return (unsigned long long)(long long)(int16_t)(word_of(v, j >> 1) >> ((j & 1) * 16));
  return (unsigned long long)(long long)(int32_t)word_of(v, j);
}

// Loads the thread's payload as uint4s when the shard's payload is 16-byte
// aligned and holds the whole chunk; returns whether it did.
template <int kKind>
__device__ __forceinline__ bool load_vec(const unsigned char* dbase, long long pbytes, bool aligned,
                                         long long row0, uint4 (&v)[(DeltaCfg<kKind>::kBytes + 15) / 16]) {
  using C = DeltaCfg<kKind>;
  const long long byte0 = kKind == 0 ? row0 / 2 : row0 * C::kElem;
  if (!aligned || byte0 + C::kBytes > pbytes) return false;
#pragma unroll
  for (int q = 0; q < C::kBytes / 16; ++q) v[q] = __ldg(reinterpret_cast<const uint4*>(dbase + byte0) + q);
  return true;
}

// The thread's kRows values of d64 (delta + off; 0 at row 0 and at rows
// >= r) for the rows from row0: without a per-row test when every row is
// in (0, r), row by row where the payload could not be read as vectors.
template <int kKind>
__device__ __forceinline__ void load_d64(const unsigned char* dbase, long long pbytes, bool aligned,
                                         long long row0, long long r, long long off,
                                         unsigned long long (&d64)[DeltaCfg<kKind>::kRows]) {
  using C = DeltaCfg<kKind>;
  uint4 v[(C::kBytes + 15) / 16];
  if (row0 >= r) {
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) d64[j] = 0ull;
  } else if (load_vec<kKind>(dbase, pbytes, aligned, row0, v)) {
    if (row0 > 0 && row0 + C::kRows <= r) {
#pragma unroll
      for (int j = 0; j < C::kRows; ++j) d64[j] = delta_of<kKind>(v, j) + (unsigned long long)off;
    } else {
#pragma unroll
      for (int j = 0; j < C::kRows; ++j) {
        const long long i = row0 + j;
        d64[j] = (i > 0 && i < r) ? delta_of<kKind>(v, j) + (unsigned long long)off : 0ull;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) {
      const long long i = row0 + j;
      d64[j] = (i > 0 && i < r) ? load_delta<kKind>(dbase, i) + (unsigned long long)off : 0ull;
    }
  }
}

// The sum of a whole chunk's raw deltas (sign-extended): nibbles and bytes
// a word at a time (SWAR), other kinds row by row.
template <int kKind>
__device__ __forceinline__ unsigned long long chunk_sum(const uint4 (&v)[(DeltaCfg<kKind>::kBytes + 15) / 16]) {
  using C = DeltaCfg<kKind>;
  unsigned long long t = 0ull;
  if (kKind == 0 || kKind == 1) {
#pragma unroll
    for (int w = 0; w < C::kBytes / 4; ++w) {
      const unsigned int x = word_of(v, w);
      if (kKind == 0) {
        const unsigned int b = (x & 0x0F0F0F0Fu) + ((x >> 4) & 0x0F0F0F0Fu);  // bytes <= 30
        t += (b * 0x01010101u) >> 24;
      } else {
        const unsigned int h = (x & 0x00FF00FFu) + ((x >> 8) & 0x00FF00FFu);  // halves <= 510
        t += (h & 0xFFFFu) + (h >> 16);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) t += delta_of<kKind>(v, j);
  }
  return t;
}

// Where a tile's payload starts, its byte width and whether it is 16-byte
// aligned.
template <int kKind>
__device__ __forceinline__ const unsigned char* shard_payload(const void* deltas, long long dstride,
                                                              int s, long long* pbytes,
                                                              bool* aligned) {
  using C = DeltaCfg<kKind>;
  *pbytes = kKind == 0 ? dstride : dstride * C::kElem;
  const unsigned char* p = static_cast<const unsigned char*>(deltas) + s * *pbytes;
  *aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  return p;
}

// Pass 1: each tile's sum of d64, written in full (no flags, no zeroed
// scratch).
template <int kKind>
__global__ void __launch_bounds__(DeltaCfg<kKind>::kThreads)
    delta_tile_sums_kernel(const void* __restrict__ deltas, long long dstride,
                           const int* __restrict__ rows, long long off, long long L,
                           int tiles_per_shard, unsigned long long* __restrict__ sums) {
  using C = DeltaCfg<kKind>;
  __shared__ unsigned long long warp_sum[C::kWarps];
  const int tile = blockIdx.x;
  const int s = tile / tiles_per_shard;
  const int k = tile - s * tiles_per_shard;
  long long pbytes;
  bool aligned;
  const unsigned char* dbase = shard_payload<kKind>(deltas, dstride, s, &pbytes, &aligned);
  const long long r = min((long long)rows[s], L);
  const long long row0 = (long long)k * kDeltaTile + threadIdx.x * C::kRows;
  unsigned long long acc = 0ull;
  uint4 v[(C::kBytes + 15) / 16];
  if (row0 > 0 && row0 + C::kRows <= r && load_vec<kKind>(dbase, pbytes, aligned, row0, v)) {
    acc = chunk_sum<kKind>(v) + (unsigned long long)C::kRows * (unsigned long long)off;
  } else {
    unsigned long long d64[C::kRows];
    load_d64<kKind>(dbase, pbytes, aligned, row0, r, off, d64);
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) acc += d64[j];
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0ull;
#pragma unroll
    for (int w = 0; w < C::kWarps; ++w) t += warp_sum[w];
    sums[tile] = t;
  }
}

// Pass 2: one CTA a shard turns its tile sums, in place, into each tile's
// exclusive prefix plus the shard's base.
constexpr int kScanCta = 1024;

__global__ void __launch_bounds__(kScanCta)
    delta_tile_scan_kernel(const long long* __restrict__ bases, int tiles_per_shard,
                           unsigned long long* __restrict__ sums) {
  __shared__ unsigned long long warp_incl[kScanCta / 32];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long carry = (unsigned long long)bases[s];
  unsigned long long* t = sums + (long long)s * tiles_per_shard;
  for (int c0 = 0; c0 < tiles_per_shard; c0 += kScanCta) {
    const int i = c0 + threadIdx.x;
    const unsigned long long x = i < tiles_per_shard ? t[i] : 0ull;
    unsigned long long incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      unsigned long long w = warp_incl[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_incl[lane] = w;
    }
    __syncthreads();
    incl += warp ? warp_incl[warp - 1] : 0ull;
    if (i < tiles_per_shard) t[i] = carry + incl - x;
    const unsigned long long total = warp_incl[31];
    __syncthreads();  // warp_incl is reused by the next chunk
    carry += total;
  }
}

// Staging words of a tile: one padding word after every 32, so that the
// threads' strided writes of their own rows fall in distinct banks.
__device__ __forceinline__ int padded(int w) { return w + (w >> 5); }

// Pass 3: each tile re-reads its payload, scans it in registers and across
// the CTA, adds its prefix, stages the low bytes of each sum in shared
// memory and writes the tile out in 16-byte vectors (row by row where the
// shard's block is not 16-byte aligned).
template <int kKind, typename OT>
__global__ void __launch_bounds__(DeltaCfg<kKind>::kThreads)
    delta_decode_kernel(const void* __restrict__ deltas, long long dstride,
                        const int* __restrict__ rows, long long off, long long L,
                        int tiles_per_shard, const unsigned long long* __restrict__ prefix,
                        OT* __restrict__ out) {
  using C = DeltaCfg<kKind>;
  constexpr int kWords = kDeltaTile * (int)sizeof(OT) / 4;   // the tile's bytes as words
  constexpr int kThreadWords = C::kRows * (int)sizeof(OT) / 4;
  __shared__ unsigned int stage[kWords + kWords / 32];
  __shared__ unsigned long long warp_incl[C::kWarps];
  const int tile = blockIdx.x;
  const int s = tile / tiles_per_shard;
  const int k = tile - s * tiles_per_shard;
  long long pbytes;
  bool aligned;
  const unsigned char* dbase = shard_payload<kKind>(deltas, dstride, s, &pbytes, &aligned);
  const long long r = min((long long)rows[s], L);
  const unsigned long long tile_prefix = prefix[tile];  // in flight with the payload
  const long long tile0 = (long long)k * kDeltaTile;
  const long long row0 = tile0 + threadIdx.x * C::kRows;
  unsigned long long run[C::kRows];
  load_d64<kKind>(dbase, pbytes, aligned, row0, r, off, run);
  unsigned long long acc = 0ull;
#pragma unroll
  for (int j = 0; j < C::kRows; ++j) {
    acc += run[j];
    run[j] = acc;
  }

  // CTA-wide exclusive scan of the thread totals.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long tincl = acc;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, tincl, o);
    if (lane >= o) tincl += y;
  }
  if (lane == 31) warp_incl[warp] = tincl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < C::kWarps ? warp_incl[lane] : 0ull;
    for (int o = 1; o < C::kWarps; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < C::kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  const unsigned long long base = tile_prefix + (warp ? warp_incl[warp - 1] : 0ull) + tincl - acc;

  // The thread's rows as words of OT, little-endian, into the staging
  // (1- and 2-byte values packed into words first).
  const int w0 = threadIdx.x * kThreadWords;
  if (sizeof(OT) >= 4) {
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) {
      const unsigned long long v = row0 + j < r ? base + run[j] : 0ull;
      if (sizeof(OT) == 8) {
        stage[padded(w0 + 2 * j)] = (unsigned int)v;
        stage[padded(w0 + 2 * j + 1)] = (unsigned int)(v >> 32);
      } else {
        stage[padded(w0 + j)] = (unsigned int)v;
      }
    }
  } else {
    constexpr int kPer = 4 / (int)sizeof(OT);  // values a word
#pragma unroll
    for (int w = 0; w < kThreadWords; ++w) {
      unsigned int word = 0u;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int j = w * kPer + q;
        const unsigned long long v = row0 + j < r ? base + run[j] : 0ull;
        word |= ((unsigned int)v & (sizeof(OT) == 2 ? 0xFFFFu : 0xFFu)) << (q * 8 * (int)sizeof(OT));
      }
      stage[padded(w0 + w)] = word;
    }
  }
  __syncthreads();

  const int nrows = (int)min((long long)kDeltaTile, L - tile0);
  OT* o = out + (long long)s * L + tile0;
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    const int nbytes = nrows * (int)sizeof(OT);
    unsigned char* ob = reinterpret_cast<unsigned char*>(o);
    for (int c = threadIdx.x; c * 16 < nbytes; c += C::kThreads) {
      if (c * 16 + 16 <= nbytes) {
        const uint4 q = make_uint4(stage[padded(4 * c)], stage[padded(4 * c + 1)],
                                   stage[padded(4 * c + 2)], stage[padded(4 * c + 3)]);
        *reinterpret_cast<uint4*>(ob + 16 * c) = q;
      } else {
        for (int b = 16 * c; b < nbytes; ++b) {
          ob[b] = (unsigned char)(stage[padded(b >> 2)] >> ((b & 3) * 8));
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < nrows; e += C::kThreads) {
      if (sizeof(OT) == 8) {
        o[e] = (OT)(((unsigned long long)stage[padded(2 * e + 1)] << 32) | stage[padded(2 * e)]);
      } else if (sizeof(OT) == 4) {
        o[e] = (OT)stage[padded(e)];
      } else if (sizeof(OT) == 2) {
        o[e] = (OT)(stage[padded(e >> 1)] >> ((e & 1) * 16));
      } else {
        o[e] = (OT)(stage[padded(e >> 2)] >> ((e & 3) * 8));
      }
    }
  }
}

template <int kKind>
cudaError_t launch_delta_kind(const void* bases, const void* deltas, long long dstride,
                              const void* rows, long long off, int d, long long L, int out_size,
                              void* out, void* sums, cudaStream_t stream) {
  using C = DeltaCfg<kKind>;
  const int tps = (int)((L + kDeltaTile - 1) / kDeltaTile);
  const dim3 grid((unsigned int)((long long)d * tps));
  unsigned long long* t = static_cast<unsigned long long*>(sums);
  delta_tile_sums_kernel<kKind><<<grid, C::kThreads, 0, stream>>>(deltas, dstride, (const int*)rows,
                                                                  off, L, tps, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  delta_tile_scan_kernel<<<d, kScanCta, 0, stream>>>((const long long*)bases, tps, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define PX_DELTA(OT)                                                                    \
  delta_decode_kernel<kKind, OT><<<grid, C::kThreads, 0, stream>>>(deltas, dstride,     \
                                                                   (const int*)rows, off, \
                                                                   L, tps, t, (OT*)out)
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

// values: [d, R] elements of `elem_size` bytes; ends: int32 [d, R],
// ascending in each shard; out: [d, L] elements of `elem_size` bytes, L <
// 2^31, d <= 65535; probe: null, or int64 [4] for the first CTA's clock64
// at the start and after the search, the staging and the expansion.
int px_codec_rle_decode(const void* values, const void* ends, int d, int R, long long L,
                        int elem_size, void* out, void* probe, void* stream) {
  if (d <= 0 || R <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (elem_size) {
    case 1: return (int)launch_rle<uint8_t>(values, ends, d, R, L, out, probe, st);
    case 2: return (int)launch_rle<uint16_t>(values, ends, d, R, L, out, probe, st);
    case 4: return (int)launch_rle<uint32_t>(values, ends, d, R, L, out, probe, st);
    case 8: return (int)launch_rle<unsigned long long>(values, ends, d, R, L, out, probe, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bases: int64 [d]; deltas: [d, dstride] of `kind` (0 nibbles: dstride =
// ceil(L / 2) bytes); rows: int32 [d]; out: [d, L] elements of `out_size`
// bytes; scratch: int64 [d * ceil(L / 4096)], any contents (the tile sums,
// then the tiles' prefixes). Enqueues three grids.
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
