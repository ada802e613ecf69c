// Hand-written CUDA kernels of the sketch UDAs (t-digest, count-min,
// HyperLogLog), built for Hopper (sm_90a) into the same ctypes library as
// hopper_kernels.cu (ops/kernels/__init__.py). Each launches on the CUDA
// runtime's current device and the caller's stream, allocates nothing, and
// returns the cudaError_t of its launch.
//
// hash  px_hash32            replaces pixie_tpu/ops/hashing.py u32_words,
//    mix32, hash32, hash32_pair (:78-112): one or two u32 hashes per word.
//    No path calls it: H5, H6, H20 and H21 hash in registers.
// H5  px_hll_update          replaces pixie_tpu/ops/hll.py _reg_rho + update
//    (:43, :54), with hash32 and clz32 (:100, :114) inlined.
// H6  px_countmin_update     replaces pixie_tpu/ops/countmin.py _buckets +
//    update (:48, :58), with hash32_pair (hashing.py:106) inlined, and the
//    UDA's per-group total (seg_count).
// H7a px_tdigest_pack        replaces the key packing of
//    pixie_tpu/ops/tdigest.py _packed_sort (:56) and the group counts of
//    update (:78); the sort between H7a and H7b is torch.sort.
// H7b px_tdigest_cluster     replaces the rank, k1 cluster and per-cluster
//    sums of pixie_tpu/ops/tdigest.py update (:78).
//    H7a and H7b update more than 254 groups (int64 keys); H7
//    (tdigest_kernels.cu) updates up to 254 without a sort.
// H8  px_tdigest_merge       replaces pixie_tpu/ops/tdigest.py merge (:133).
// H9  px_tdigest_quantiles   replaces pixie_tpu/ops/tdigest.py
//    quantile_values (:163).
// H10 px_hll_estimate        replaces pixie_tpu/ops/hll.py estimate (:118).
// H30 px_countmin_query      replaces pixie_tpu/ops/countmin.py query
//    (:114-120) with its _buckets (:48): the min over the depth rows.
//
// What bounds them on an H100. The hash kernel, H7a and H7b read each row
// once (8-16 bytes) and are bytes-bound when their atomics keep up. H5 reads
// the value column where the fold staged it (rows.cuh: a narrowed column's
// 1-4 bytes and its offset, not a widened int64 word) with the streaming
// hint, 8 rows a thread. It keeps its registers in shared memory while
// [G, 2^p] int32 fits a block (G <= 28 at p = 11), one wave of CTAs;
// otherwise each row reads its global register and issues an atomic max
// only where it would raise it, and the random 4-byte accesses of a 32 MB
// register file (4096 groups), in L2 and DRAM sectors, not the rows, set
// its time. H6 reads the word column as staged (a narrowed INT64 column's
// 1-4 bytes and its offset, or the arghash lane's int64 words), hashes it in
// registers, and counts equal (group, h1 mod width, h2 mod width) keys in an
// open-addressed table in shared memory before any global atomic: a key's
// depth cells take one add of its count a CTA, not one a row, so the rows
// (13 bytes each at most), the table's shared atomics and the flush's
// global adds (one a cell and CTA) set its time, not the L2's same-address
// atomics; a row that finds no slot adds to its cells at once, as every row
// did before. H7b reads the sorted keys as 16-byte vectors, a warp's loads
// one contiguous span, takes each row's rank from its group's start (a
// scan of H7a's counts in shared memory, not a search over the keys) and
// joins the rows of a (group, cluster) run across a warp's lanes by
// shuffles: one pair of global f64 adds a run and warp, not a row; its f32
// rank, division and asinf a row, not its 4 bytes, set its time.
// H8 is one CTA a group: its 2C centroids' ranks by a binary search a
// key (not 2C compares), one scan, the cluster of each midpoint and one
// segmented scan, about 2 barriers a step; at the main path's 16 groups
// it is bound by its latency (16 CTAs, a launch, dependent shared-memory
// steps), not by its bytes. H9 is a warp a group (its loads, a shuffle scan,
// and about 36 shuffles that search every q at once), latency-bound at the
// main path's 16 groups: its launch sets most of its time. H10 is a warp a group with the sum in
// integers (no shared memory, no barrier): at flows' 4096 groups of 2048
// registers its 32 MB read sets its time; at 16 to 64 groups, its launch.
// H30 is a gather: one thread a query hashes its word once and reads its
// group's depth cells, so it moves 12 bytes in and 8 out a query plus the
// cells it touches; at config 10's 64 x 4 x 8192 state (16 MB) the cells
// stay in L2.
//
// Float arithmetic. The t-digest's f32 steps (rank + 0.5, the division by
// the count, 2q - 1, the division by pi, + 0.5, * capacity, and those of
// H8 and H9) use the __f*_rn intrinsics, so nvcc cannot contract them into
// FMAs and each rounds on its own, as the reference's quantile_values does
// when XLA-CPU compiles it alone (inside a larger fused program XLA-CPU
// contracts some of them; PERF.md's quantile bound covers that).
// H7b's asinf is CUDA's accurate one (no fast-math); it may differ from
// XLA's and the plain version's arcsin by an ulp or two, which moves a
// cluster id by one only where k(q) * capacity lies within 1e-4 of an
// integer (the Fault-4 contract, PERF.md). H8 takes the plain version's
// f64 asin rounded to f32 (tdigest_cluster.cuh), so its clusters are the
// plain version's on the card. Per-cluster sums of H7b add in f64 and round
// to f32 once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "rows.cuh"
#include "sketch_hash.cuh"
#include "tdigest_cluster.cuh"

namespace {

using px::allow_smem;
using px::grid_for;
using px::kThreads;

constexpr float kPiF = 3.14159265358979323846f;

// ---------------------------------------------------------------- hash
__global__ void hash32_kernel(const unsigned long long* __restrict__ words, long long n,
                              uint32_t seed, int pair, uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned long long w = words[i];
    if (pair) {
      const uint2 h = px::hash32_pair(w, seed);
      out[i] = h.x;
      out[n + i] = h.y;
    } else {
      out[i] = px::hash32(w, seed);
    }
  }
}

// ---------------------------------------------------------------- H5
// The value column as staged (rows.cuh): the word a row hashes is its
// 64-bit value plus the offset (kU32 and kF64 take offset 0: the
// reference's u32 words of an int32 column and a double's bits).
struct HllArgs {
  const void* vals;
  long long off;
  int kind;
  int vec_vals;
  int vec;  // gids and mask take vector loads
  const int* gids;
  const unsigned char* mask;
  long long n;
  int S;
  int precision;
  int* state;
};

// (register cell, rho) of row i0 + j for the 8 rows a thread takes; cell
// -1 for an invalid row.
__device__ __forceinline__ void hll_rows8(const HllArgs& a, long long i0,
                                          long long (&cell)[px::kRowsPerThread],
                                          int (&rho)[px::kRowsPerThread]) {
  int g[px::kRowsPerThread];
  unsigned long long v[px::kRowsPerThread];
  px::load_gids8(a.gids, a.mask, i0, a.n, a.S, a.vec != 0, g);
  px::load_vals8(a.vals, a.kind, i0, a.n, a.vec_vals != 0, v);
  const int p = a.precision;
  const int rho_max = 32 - p + 1;
#pragma unroll
  for (int j = 0; j < px::kRowsPerThread; ++j) {
    const uint32_t h = px::hash32(v[j] + (unsigned long long)a.off, 0u);
    rho[j] = min(px::clz32(h << p) + 1, rho_max);
    cell[j] = g[j] < 0 ? -1 : ((long long)g[j] << p) + (long long)(h >> (32 - p));
  }
}

// Few groups ([S, 2^p] int32 in the opt-in shared memory): per-CTA
// registers, one wave of CTAs, 8 rows a thread, then one atomic max per
// non-zero register and CTA.
__global__ void __launch_bounds__(kThreads) hll_shared_kernel(const HllArgs a) {
  extern __shared__ int sh_regs[];
  const long long cells = (long long)a.S << a.precision;
  for (long long c = threadIdx.x; c < cells; c += blockDim.x) sh_regs[c] = 0;
  __syncthreads();
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    long long cell[px::kRowsPerThread];
    int rho[px::kRowsPerThread];
    hll_rows8(a, c * px::kRowsPerThread, cell, rho);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (cell[j] >= 0 && sh_regs[cell[j]] < rho[j]) atomicMax(&sh_regs[cell[j]], rho[j]);
    }
  }
  __syncthreads();
  for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
    const int v = sh_regs[c];
    if (v > 0 && a.state[c] < v) atomicMax(&a.state[c], v);
  }
}

// Many groups: one pass, 8 rows a thread, read with the streaming hint
// (evict first); every register read is issued before any atomic, and the
// atomic max (its result unused: a reduction) only where the read is below
// rho. Registers only grow, so a stale read can only cost an extra atomic;
// once registers fill, most rows issue none, and the fewer dirty lines the
// L2 writes back.
__global__ void __launch_bounds__(kThreads) hll_onepass_kernel(const HllArgs a) {
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    long long cell[px::kRowsPerThread];
    int rho[px::kRowsPerThread], cur[px::kRowsPerThread];
    hll_rows8(a, c * px::kRowsPerThread, cell, rho);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      cur[j] = cell[j] >= 0 ? __ldcg(a.state + cell[j]) : 64;
    }
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (cur[j] < rho[j]) atomicMax(a.state + cell[j], rho[j]);
    }
  }
}

// ---------------------------------------------------------------- H6
// The value column as staged (rows.cuh), each row's word as H5's: its
// 64-bit value plus the offset (kU32 and kF64 take offset 0), hashed in
// registers by hash32_pair(word, 1).
struct CmArgs {
  const void* vals;
  long long off;
  int kind;
  int vec_vals;
  int vec;  // gids and mask take vector loads
  const int* gids;
  const unsigned char* mask;
  long long n;
  int S;
  int depth;
  int wbits;  // width = 2^wbits
  unsigned long long* cm;
  unsigned long long* total;
  int tbits;          // a CTA's table: 2^tbits slots (0: no table)
  int shared_totals;  // the S totals as u32 in shared memory
};

constexpr unsigned long long kEmptySlot = ~0ull;
constexpr int kCmProbe = 32;  // slots a row probes before it goes straight to the cells

// A row's table key: (gid, h1 mod width, h2 mod width). Bucket d is
// (h1 + d * h2) mod width, which only the residues decide, so rows with one
// key add to the same depth cells: counting keys is exact. 31 + 2 * wbits
// <= 63 bits (wbits <= 16), so no key is the empty slot's all-ones.
__device__ __forceinline__ unsigned long long cm_key(int g, uint2 h, int wbits) {
  const uint32_t wmask = (1u << wbits) - 1u;
  return ((unsigned long long)g << (2 * wbits)) |
         ((unsigned long long)(h.x & wmask) << wbits) | (unsigned long long)(h.y & wmask);
}

__device__ __forceinline__ void add_cells(const CmArgs& a, int g, uint32_t h1, uint32_t h2,
                                          unsigned long long cnt) {
  const uint32_t wmask = (1u << a.wbits) - 1u;
  unsigned long long* row = a.cm + (((long long)g * a.depth) << a.wbits);
  for (int d = 0; d < a.depth; ++d) {
    atomicAdd(&row[((long long)d << a.wbits) + ((h1 + (uint32_t)d * h2) & wmask)], cnt);
  }
}

__device__ __forceinline__ void add_total(const CmArgs& a, unsigned int* sh_tot, int g,
                                          unsigned int cnt) {
  if (a.shared_totals) {
    atomicAdd(&sh_tot[g], cnt);
  } else {
    atomicAdd(&a.total[g], (unsigned long long)cnt);
  }
}

// A key's count into its depth cells and its group's total.
__device__ __forceinline__ void add_key(const CmArgs& a, unsigned int* sh_tot,
                                        unsigned long long key, unsigned int cnt) {
  const uint32_t wmask = (1u << a.wbits) - 1u;
  const int g = (int)(key >> (2 * a.wbits));
  add_cells(a, g, (uint32_t)(key >> a.wbits) & wmask, (uint32_t)key & wmask, cnt);
  add_total(a, sh_tot, g, cnt);
}

__device__ __forceinline__ unsigned int slot_of(unsigned long long key, int bits) {
  return (unsigned int)((key * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

// Adds one to key's slot of an open-addressed table of 2^bits slots (keys,
// u32 counts, in shared memory): a free slot is claimed by a
// compare-and-swap on its key. False when kCmProbe slots from the key's
// home hold other keys: the caller adds the row to its cells.
__device__ __forceinline__ bool table_add(unsigned long long* keys, unsigned int* cnts, int bits,
                                          unsigned long long key) {
  const unsigned int tmask = (1u << bits) - 1u;
  unsigned int s = slot_of(key, bits);
  for (int p = 0; p < kCmProbe; ++p, s = (s + 1u) & tmask) {
    unsigned long long k = *(volatile unsigned long long*)&keys[s];
    if (k == kEmptySlot) {
      k = atomicCAS(&keys[s], kEmptySlot, key);
      if (k == kEmptySlot) k = key;
    }
    if (k == key) {
      atomicAdd(&cnts[s], 1u);
      return true;
    }
  }
  return false;
}

// Each CTA counts its rows' keys in its table (shared atomics), one CTA an
// SM; a row that finds no slot adds one to its cells and total at once.
// Then the CTA adds each key's count to its cells and the totals. Measured
// on the H100 (PERF.md §6): tables merged across a cluster of 8 through
// distributed shared memory before the flush, 1024 threads a CTA, or two
// CTAs an SM were no faster at endpoint_load's 4098 keys.
__global__ void __launch_bounds__(kThreads) countmin_table_kernel(const CmArgs a) {
  extern __shared__ unsigned long long sh_cm[];
  const int T = a.tbits > 0 ? 1 << a.tbits : 0;
  unsigned long long* keys = sh_cm;                                 // [T]
  unsigned int* cnts = reinterpret_cast<unsigned int*>(keys + T);  // [T]
  unsigned int* sh_tot = cnts + T;                                  // [S] with shared_totals
  for (int s = threadIdx.x; s < T; s += blockDim.x) {
    keys[s] = kEmptySlot;
    cnts[s] = 0u;
  }
  if (a.shared_totals) {
    for (int g = threadIdx.x; g < a.S; g += blockDim.x) sh_tot[g] = 0u;
  }
  __syncthreads();
  // Each thread's next chunk is loaded before it counts the current one,
  // so a chunk's loads overlap the previous chunk's table work.
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int gn[px::kRowsPerThread];
  unsigned long long vn[px::kRowsPerThread];
  if (c < chunks) {
    px::load_gids8(a.gids, a.mask, c * px::kRowsPerThread, a.n, a.S, a.vec != 0, gn);
    px::load_vals8(a.vals, a.kind, c * px::kRowsPerThread, a.n, a.vec_vals != 0, vn);
  }
  for (; c < chunks; c += stride) {
    int g[px::kRowsPerThread];
    unsigned long long v[px::kRowsPerThread];
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      g[j] = gn[j];
      v[j] = vn[j];
    }
    if (c + stride < chunks) {
      const long long i1 = (c + stride) * px::kRowsPerThread;
      px::load_gids8(a.gids, a.mask, i1, a.n, a.S, a.vec != 0, gn);
      px::load_vals8(a.vals, a.kind, i1, a.n, a.vec_vals != 0, vn);
    }
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (g[j] < 0) continue;
      const uint2 h = px::hash32_pair(v[j] + (unsigned long long)a.off, 1u);
      if (T > 0 && table_add(keys, cnts, a.tbits, cm_key(g[j], h, a.wbits))) continue;
      add_cells(a, g[j], h.x, h.y, 1ull);
      add_total(a, sh_tot, g[j], 1u);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < T; s += blockDim.x) {
    if (keys[s] != kEmptySlot) add_key(a, sh_tot, keys[s], cnts[s]);
  }
  if (a.shared_totals) {
    __syncthreads();
    for (int g = threadIdx.x; g < a.S; g += blockDim.x) {
      if (sh_tot[g] != 0u) atomicAdd(&a.total[g], (unsigned long long)sh_tot[g]);
    }
  }
}

// ---------------------------------------------------------------- H7a
// The order-preserving u32 map of an f32's bits: negatives flipped, the
// sign bit set on the rest.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t mp) {
  return __uint_as_float((mp >> 31) ? (mp & 0x7FFFFFFFu) : ~mp);
}

// Each row's sort key and the row count of each group (masked rows and gids
// outside [0, G) go to the sentinel group G). Packed (G <= 254): the
// u32 key (group << (32 - bits_g)) | (order_key >> bits_g), stored with its
// sign bit flipped so that a signed int32 sort orders it as u32. Wide: the
// int64 key (group << 32) | order_key.
__global__ void tdigest_pack_kernel(const float* __restrict__ values, long long n,
                                    const int* __restrict__ gids,
                                    const unsigned char* __restrict__ mask, int G,
                                    int bits_g, int wide, void* __restrict__ keys,
                                    int* __restrict__ counts, int counts_shared) {
  extern __shared__ int sh_counts[];
  if (counts_shared) {
    for (int c = threadIdx.x; c <= G; c += blockDim.x) sh_counts[c] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int g = gids[i];
    if ((mask != nullptr && !mask[i]) || g < 0 || g >= G) g = G;
    const uint32_t mapped = order_key(values[i]);
    if (wide) {
      ((unsigned long long*)keys)[i] = ((unsigned long long)g << 32) | mapped;
    } else {
      const uint32_t key = ((uint32_t)g << (32 - bits_g)) | (mapped >> bits_g);
      ((uint32_t*)keys)[i] = key ^ 0x80000000u;
    }
    atomicAdd(counts_shared ? &sh_counts[g] : &counts[g], 1);
  }
  if (counts_shared) {
    __syncthreads();
    for (int c = threadIdx.x; c <= G; c += blockDim.x) {
      if (sh_counts[c] != 0) atomicAdd(&counts[c], sh_counts[c]);
    }
  }
}

// ---------------------------------------------------------------- H7b
// The k1-scale cluster of a mid-quantile, as pixie_tpu/ops/tdigest.py
// _cluster_ids computes it in f32: clip(q, 1e-7, 1 - 1e-7), 2q - 1,
// arcsin / pi + 0.5, * capacity, floor, clip.
__device__ __forceinline__ int cluster_id(float q, int C) {
  q = fminf(fmaxf(q, 1e-7f), (float)(1.0 - 1e-7));
  const float x = __fsub_rn(__fmul_rn(2.0f, q), 1.0f);
  const float k = __fadd_rn(__fdiv_rn(asinf(x), kPiF), 0.5f);
  const int c = __float2int_rz(floorf(__fmul_rn(k, (float)C)));
  return min(max(c, 0), C - 1);
}

// A sorted key's group and value: packed u32 keys (stored with the sign bit
// flipped) or int64 (group << 32 | order key).
__device__ __forceinline__ void decode_key(uint32_t key, int bits_g, int* g, float* v) {
  const uint32_t k = key ^ 0x80000000u;
  *g = (int)(k >> (32 - bits_g));
  *v = from_order_key(k << bits_g);
}

__device__ __forceinline__ void decode_key(unsigned long long key, int, int* g, float* v) {
  *g = (int)(key >> 32);
  *v = from_order_key((uint32_t)key);
}

// A 16-byte vector's keys in row order.
__device__ __forceinline__ void unpack_keys(const uint4 w, uint32_t (&k)[4]) {
  k[0] = w.x; k[1] = w.y; k[2] = w.z; k[3] = w.w;
}

__device__ __forceinline__ void unpack_keys(const uint4 w, unsigned long long (&k)[2]) {
  k[0] = ((unsigned long long)w.y << 32) | w.x;
  k[1] = ((unsigned long long)w.w << 32) | w.z;
}

constexpr int kTdThreads = 512;
constexpr int kTdVecs = 2;  // 16-byte vectors a thread a tile
// Groups whose starts each CTA scans into shared memory (ops/kernels/
// __init__.py TD_SHARED_STARTS); above, one CTA scans them into scratch
// first.
constexpr int kTdSharedStarts = 16384;

// dst[g] = counts[0] + ... + counts[g - 1] for g <= G + 1 (counts has G + 1
// entries), by one CTA: chunks of blockDim counts, each a warp scan, the
// warps' totals scanned by warp 0, and the running total carried on.
__device__ void scan_counts(const int* __restrict__ counts, int G, int* dst) {
  __shared__ int sh_wsum[32];
  __shared__ int sh_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if (threadIdx.x == 0) sh_carry = 0;
  __syncthreads();
  for (int base = 0; base <= G + 1; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int c = i <= G ? counts[i] : 0;
    int s = c;  // inclusive warp scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += t;
    }
    if (lane == 31) sh_wsum[warp] = s;
    __syncthreads();
    if (warp == 0) {
      int w = lane < warps ? sh_wsum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= d) w += t;
      }
      if (lane < warps) sh_wsum[lane] = w;
    }
    __syncthreads();
    const int excl = sh_carry + (warp > 0 ? sh_wsum[warp - 1] : 0) + s - c;
    if (i <= G + 1) dst[i] = excl;
    __syncthreads();
    if (threadIdx.x == 0) sh_carry += sh_wsum[warps - 1];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTdThreads) tdigest_starts_kernel(const int* __restrict__ counts,
                                                                   int G, int* __restrict__ starts) {
  scan_counts(counts, G, starts);
}

// Over the sorted keys, every CTA a tile of consecutive rows a trip, each
// thread kTdVecs 16-byte vectors of them (a warp's loads one contiguous
// span), read with the streaming hint: a row's rank is its index less its
// group's start (the exclusive scan of H7a's counts: no search over the
// keys), its mid-quantile (rank + 0.5) / count, its cluster as today's
// kernel computed it, its cell g * C + cluster. Sorted keys give runs of
// equal cells: a thread's rows are added up a run, the warp joins the runs
// that cross its lanes by a segmented shuffle scan, and the lane where a
// run ends issues the run's two global f64 adds (weight, value) into sums
// [2, G * C], zeroed by the caller. A run cut by a warp's edge adds twice,
// and so does a cell that comes back: nothing rests on the order of the
// clusters. Rows past the live ones (the starts' G-th entry: the masked
// rows' sentinel group sorts last) end the walk.
template <typename K>
__global__ void __launch_bounds__(kTdThreads) tdigest_cluster_kernel(
    const K* __restrict__ keys, long long n, const int* __restrict__ counts, int G, int C,
    int bits_g, int vec, const int* __restrict__ starts_in, double* __restrict__ sums) {
  constexpr int V = 16 / sizeof(K);  // keys a vector
  constexpr int TILE = kTdThreads * kTdVecs * V;
  extern __shared__ int sh_starts[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The first tile's loads go out before the scan.
  K cur[kTdVecs][V];
  auto load = [&](long long base, K (&k)[kTdVecs][V]) {
#pragma unroll
    for (int u = 0; u < kTdVecs; ++u) {
      const long long i0 = base + ((long long)(u * (kTdThreads / 32) + warp) * 32 + lane) * V;
      if (vec && i0 + V <= n) {
        unpack_keys(__ldcs(reinterpret_cast<const uint4*>(keys + i0)), k[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) k[u][j] = i0 + j < n ? keys[i0 + j] : (K)0;
      }
    }
  };
  long long base = (long long)blockIdx.x * TILE;
  if (base < n) load(base, cur);
  const int* starts = starts_in;
  if (starts == nullptr) {
    scan_counts(counts, G, sh_starts);
    __syncthreads();
    starts = sh_starts;
  }
  const long long live = starts[G];
  const int cells = G * C;
  for (; base < live; base += (long long)gridDim.x * TILE) {
    K nxt[kTdVecs][V];
    const long long next = base + (long long)gridDim.x * TILE;
    if (next < live) load(next, nxt);
#pragma unroll
    for (int u = 0; u < kTdVecs; ++u) {
      const long long i0 = base + ((long long)(u * (kTdThreads / 32) + warp) * 32 + lane) * V;
      int cell[V];
      double v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        cell[j] = -1;
        v[j] = 0.0;
        if (i0 + j < live) {
          int g;
          float x;
          decode_key(cur[u][j], bits_g, &g, &x);
          const int start = starts[g];
          // The rank and count as ints convert to the floats today's kernel
          // took from their 64-bit values: the same integers.
          const float rank = (float)((int)(i0 + j) - start);
          const float cnt = (float)(starts[g + 1] - start);
          const float q = __fdiv_rn(__fadd_rn(rank, 0.5f), fmaxf(cnt, 1.0f));
          cell[j] = g * C + cluster_id(q, C);
          v[j] = (double)x;
        }
      }
      // A thread's runs: run sums (w, s) at each row, restarted at a head.
      const int before = __shfl_up_sync(0xFFFFFFFFu, cell[V - 1], 1);
      const int after = __shfl_down_sync(0xFFFFFFFFu, cell[0], 1);
      bool head[V];
      int w[V];
      double s[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        head[j] = j == 0 ? (lane == 0 || cell[0] != before) : cell[j] != cell[j - 1];
        w[j] = (j == 0 || head[j]) ? 1 : w[j - 1] + 1;
        s[j] = (j == 0 || head[j]) ? v[j] : __dadd_rn(s[j - 1], v[j]);
      }
      // The warp's segmented inclusive scan of each lane's last run,
      // (flag: a run starts in the lane, w, s); the lane before's result is
      // what this lane's first run carries in.
      bool f = false;
#pragma unroll
      for (int j = 0; j < V; ++j) f = f || head[j];
      int sw = w[V - 1];
      double ss = s[V - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int fu = __shfl_up_sync(0xFFFFFFFFu, (int)f, d);
        const int wu = __shfl_up_sync(0xFFFFFFFFu, sw, d);
        const double su = __shfl_up_sync(0xFFFFFFFFu, ss, d);
        if (lane >= d) {
          if (!f) {
            sw += wu;
            ss = __dadd_rn(su, ss);
          }
          f = f || fu;
        }
      }
      int cw = __shfl_up_sync(0xFFFFFFFFu, sw, 1);
      double cs = __shfl_up_sync(0xFFFFFFFFu, ss, 1);
      if (lane == 0 || head[0]) {
        cw = 0;
        cs = 0.0;
      }
      bool open = true;  // no head yet: rows still in the run carried in
#pragma unroll
      for (int j = 0; j < V; ++j) {
        open = open && !head[j];
        const bool tail = j + 1 < V ? cell[j] != cell[j + 1] : (lane == 31 || cell[j] != after);
        if (tail && cell[j] >= 0) {
          atomicAdd(&sums[cell[j]], (double)(w[j] + (open ? cw : 0)));
          atomicAdd(&sums[cells + cell[j]], open ? __dadd_rn(cs, s[j]) : s[j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTdVecs; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) cur[u][j] = nxt[u][j];
    }
  }
}

// ---------------------------------------------------------------- H8
// The total order of the reference's argsort keys: -0.0 == +0.0, NaN last.
__device__ __forceinline__ uint32_t sort_key(float x) {
  if (x != x) return 0xFFFFFFFFu;
  return order_key(x == 0.0f ? 0.0f : x);
}

// One CTA per group, 2C threads (rounded up to whole warps), the 2C
// centroids of a (threads 0 .. C - 1) and b, in five steps:
//  (a) classes: each centroid's argsort key (weight > 0 ? mean : +inf, by
//      sort_key) is finite (below +inf's key), +inf (the empties and +inf
//      means) or NaN; ballots and popc give each its index within its class
//      and within its half's finite keys, which are packed in order;
//  (b) rank: when each half's finite keys are nondecreasing (checked), a
//      finite key's rank is its index among its half's plus a binary search
//      into the other half's (an a key counts b's keys below it, a b key
//      a's at or below it: ties go to a first, as the stable argsort puts
//      them); +inf and NaN keys follow in concatenation order. Otherwise the
//      group counts every (key, index) pair below its own (all pairs, exact);
//  (c) the f32 cumulative weights in sorted order by a warp-shuffle scan and
//      the warps' totals in shared memory (exact for integer weights below
//      2^24, as the plain version's cumsum);
//  (d) the cluster of each midpoint (tdigest_cluster.cuh: the plain
//      version's arithmetic, nondecreasing in the midpoint);
//  (e) when the clusters are nondecreasing along the sorted order (checked),
//      each cluster's f32 sums (weights, means * weights) by a segmented
//      warp-shuffle scan, runs that cross warps joined through the warps'
//      last partial sums, the run's last position writing its cluster;
//      clusters with no run get 0. Otherwise each of the C threads walks the
//      2C centroids for its own cluster (exact).
// With raw_b, b is H7's or H7b's f64 (weight, value) sums and its
// centroids are built as the reference's update builds its batch. probe
// (null, or int64 [TD_MERGE_PROBE]): [0] groups ranked by all pairs, [1]
// groups summed by the per-cluster walk, [2..7] CTA 0's SM clock (clock64)
// at the start and after steps (a) (the loads too), (b), (c), (d), (e).
constexpr uint32_t kInfKey = 0xFF800000u;  // sort_key(+inf)
constexpr int kMergeMaxWarps = 32;

__device__ __forceinline__ void probe_clock(long long* probe, int k) {
  if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) probe[k] = clock64();
}

// The first index in [0, len) of sorted v whose value is >= x (strict) or
// > x (!strict).
__device__ __forceinline__ int bound_in(const uint32_t* v, int len, uint32_t x, bool strict) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (strict ? v[mid] < x : v[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(1024) tdigest_merge_kernel(
    const float* __restrict__ a_means, const float* __restrict__ a_weights,
    const void* __restrict__ b0, const void* __restrict__ b1, int raw_b, int C,
    float* __restrict__ out_means, float* __restrict__ out_weights,
    long long* __restrict__ probe) {
  extern __shared__ __align__(16) uint32_t sh_m[];
  const int n2 = 2 * C;
  uint32_t* keys = sh_m;                        // [n2] argsort keys by index
  uint32_t* fin = keys + n2;                    // [n2] a's finite keys at 0, b's at C
  float* sm = (float*)(fin + n2);               // [n2] means, sorted
  float* sw = sm + n2;                          // [n2] weights, sorted
  int* cls = (int*)(sw + n2);                   // [n2] clusters, sorted
  float* ow = (float*)(cls + n2);               // [C] the clusters' weights
  float* om = ow + C;                           // [C] their means * weights
  __shared__ int sh_wc[4][kMergeMaxWarps];      // class counts a warp, scanned
  __shared__ int sh_tot[4];
  __shared__ float sh_ws[kMergeMaxWarps], sh_wm[kMergeMaxWarps];
  __shared__ int sh_wf[kMergeMaxWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const bool live = t < n2;
  const long long base = (long long)blockIdx.x * C;
  probe_clock(probe, 2);
  float mv = 0.0f, wv = 0.0f;
  if (t < C) {
    mv = a_means[base + t];
    wv = a_weights[base + t];
  } else if (live && raw_b) {
    wv = (float)((const double*)b0)[base + t - C];
    const float vs = (float)((const double*)b1)[base + t - C];
    mv = wv > 0.0f ? __fdiv_rn(vs, fmaxf(wv, 1.0f)) : 0.0f;
  } else if (live) {
    mv = ((const float*)b0)[base + t - C];
    wv = ((const float*)b1)[base + t - C];
  }
  if (t < C) {
    ow[t] = 0.0f;
    om[t] = 0.0f;
  }
  // (a) classes: 0 finite, 1 +inf, 2 NaN; 3 counts the finite keys of a.
  const uint32_t key = sort_key(wv > 0.0f ? mv : __int_as_float(0x7f800000));
  const int kind = !live ? -1 : key < kInfKey ? 0 : key == kInfKey ? 1 : 2;
  if (live) keys[t] = key;
  const unsigned int below = (1u << lane) - 1u;
  int before[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned int b = __ballot_sync(0xFFFFFFFFu, c < 3 ? kind == c : (kind == 0 && t < C));
    before[c] = __popc(b & below);
    if (lane == 0) sh_wc[c][warp] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scans of the warps' counts, and the totals
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = lane < warps ? sh_wc[c][lane] : 0;
      int s = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, s, d);
        if (lane >= d) s += u;
      }
      if (lane < warps) sh_wc[c][lane] = s - x;
      if (lane == 31) sh_tot[c] = s;
    }
  }
  __syncthreads();
  const int na = sh_tot[3], nb = sh_tot[0] - na;
  const int pos = kind >= 0 ? sh_wc[kind][warp] + before[kind] : 0;  // index within the class
  const int half_pos = t < C ? pos : pos - na;  // a finite key's index within its half
  if (kind == 0) fin[(t < C ? 0 : C) + half_pos] = key;
  __syncthreads();
  const bool unsorted = __syncthreads_or(kind == 0 && half_pos > 0 &&
                                         fin[(t < C ? 0 : C) + half_pos - 1] > key);
  probe_clock(probe, 3);
  // (b) rank
  int rank = 0;
  if (!unsorted) {
    if (kind == 0) {
      rank = half_pos + (t < C ? bound_in(fin + C, nb, key, true) : bound_in(fin, na, key, false));
    } else if (kind == 1) {
      rank = sh_tot[0] + pos;
    } else if (kind == 2) {
      rank = sh_tot[0] + sh_tot[1] + pos;
    }
  } else if (live) {
    for (int j = 0; j < n2; ++j) {
      const uint32_t k = keys[j];
      rank += k < key || (k == key && j < t);
    }
  }
  if (unsorted && t == 0 && probe != nullptr) atomicAdd((unsigned long long*)&probe[0], 1ull);
  if (live) {
    sm[rank] = mv;
    sw[rank] = wv;
  }
  __syncthreads();
  probe_clock(probe, 4);
  // (c) the cumulative weights in sorted order
  const float w = live ? sw[t] : 0.0f, m = live ? sm[t] : 0.0f;
  float cum = w;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(0xFFFFFFFFu, cum, d);
    if (lane >= d) cum = __fadd_rn(cum, u);
  }
  if (lane == 31) sh_ws[warp] = cum;
  __syncthreads();
  float carry = 0.0f, total = 0.0f;
  for (int k = 0; k < warps; ++k) {
    if (k == warp) carry = total;
    total = __fadd_rn(total, sh_ws[k]);
  }
  cum = __fadd_rn(carry, cum);
  probe_clock(probe, 5);
  // (d) the cluster of each midpoint
  const int c = live ? px::td_q_cluster(
      __fdiv_rn(__fsub_rn(cum, __fmul_rn(0.5f, w)), fmaxf(total, 1.0f)), C) : C;
  if (live) cls[t] = c;
  __syncthreads();
  const int prev = t > 0 && live ? cls[t - 1] : -1;
  const bool descends = __syncthreads_or(live && c < prev);
  probe_clock(probe, 6);
  // (e) the clusters' sums
  const float mw = __fmul_rn(m, w);
  if (!descends) {
    const bool head = live && c != prev;
    float s_w = w, s_m = mw;
    int f = head;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int fu = __shfl_up_sync(0xFFFFFFFFu, f, d);
      const float wu = __shfl_up_sync(0xFFFFFFFFu, s_w, d);
      const float mu = __shfl_up_sync(0xFFFFFFFFu, s_m, d);
      if (lane >= d) {
        if (!f) {
          s_w = __fadd_rn(wu, s_w);
          s_m = __fadd_rn(mu, s_m);
        }
        f = f | fu;
      }
    }
    if (lane == 31) {
      sh_ws[warp] = s_w;
      sh_wm[warp] = s_m;
      sh_wf[warp] = f;
    }
    __syncthreads();
    const bool tail = live && (t == n2 - 1 || cls[t + 1] != c);
    if (tail) {
      for (int k = warp - 1; !f && k >= 0; --k) {  // the run began in an earlier warp
        s_w = __fadd_rn(sh_ws[k], s_w);
        s_m = __fadd_rn(sh_wm[k], s_m);
        f = sh_wf[k];
      }
      ow[c] = s_w;
      om[c] = s_m;
    }
  } else {
    if (t == 0 && probe != nullptr) atomicAdd((unsigned long long*)&probe[1], 1ull);
    if (t < C) {
      float ws = 0.0f, ms = 0.0f;
      for (int j = 0; j < n2; ++j) {
        if (cls[j] == t) {
          ws = __fadd_rn(ws, sw[j]);
          ms = __fadd_rn(ms, __fmul_rn(sm[j], sw[j]));
        }
      }
      ow[t] = ws;
      om[t] = ms;
    }
  }
  __syncthreads();
  if (t < C) {
    const float ws = ow[t];
    out_weights[base + t] = ws;
    out_means[base + t] = ws > 0.0f ? __fdiv_rn(om[t], fmaxf(ws, 1e-9f)) : 0.0f;
  }
  probe_clock(probe, 7);
}

// ---------------------------------------------------------------- H9
// A warp a group, no shared memory and no barrier; as many groups a CTA as
// there are groups for each SM, up to 8 (``tq_warps``). A lane holds 8
// consecutive centroids of a chunk of 256 (at C = 256 the whole digest: two
// 16-byte loads each of weights and means, all issued before any is used).
// A ballot asks whether every weight is a whole number in [0, 2^24] and the
// total at most 2^24 (every weight a path makes counts rows): then every
// partial sum is exact in any order, so an integer shuffle scan gives the
// sequential f32 cumulative weights and total bit for bit, and each midpoint
// cum - 0.5 w is one correctly rounded __fsub_rn of the same operands as the
// plain version's. Another group is summed in the old sequential order, one
// lane after the other in the same warp. The first non-empty centroid whose
// midpoint reaches a target is the first whose running maximum of the
// non-empty midpoints so far does (``key``, non-decreasing), so each q is a
// lower bound over sorted keys and every lane searches its own q at once:
// five shuffle steps find the lane, its 8 keys the centroid, and 18 more
// shuffles bring the midpoints and means at it and its predecessor. A q
// that no midpoint reaches takes the reference's last_valid (the count of
// non-empty centroids less one). Each lane then runs its q's f32
// interpolation, quantile_values' with every step rounded on its own. A
// digest wider than a chunk is checked and counted in one pass of its
// lanes, then searched chunk by chunk (reloaded from the L1) until every q
// of a block of 32 has its centroid.
constexpr unsigned int kTqAll = 0xFFFFFFFFu;
constexpr int kTqMaxWarps = 8;  // groups a CTA at most: a warp a group
constexpr int kTqLane = 8;      // consecutive centroids a lane
constexpr int kTqChunk = 32 * kTqLane;
constexpr unsigned int kTqExact = 1u << 24;  // the largest exact total

// Groups a CTA: about one a warp on every SM, 1 to kTqMaxWarps.
inline int tq_warps(int G) {
  const int sms = px::num_sms();
  return max(1, min(kTqMaxWarps, (G + sms - 1) / sms));
}

// A lane's weights and means of the chunk starting at c0 (0 past C);
// ``vec``: both rows 16-byte aligned and C a multiple of 4, so a 16-byte
// vector lies wholly inside or outside the row.
__device__ __forceinline__ void tq_load(const float* __restrict__ w, const float* __restrict__ m,
                                        int C, bool vec, int c0, int lane, float (&wr)[kTqLane],
                                        float (&mr)[kTqLane]) {
  const int first = c0 + lane * kTqLane;
  if (vec) {
    float4 a[kTqLane / 4], b[kTqLane / 4];
#pragma unroll
    for (int h = 0; h < kTqLane / 4; ++h) {
      const bool in = first + 4 * h < C;
      a[h] = in ? __ldg(reinterpret_cast<const float4*>(w + first) + h) : make_float4(0, 0, 0, 0);
      b[h] = in ? __ldg(reinterpret_cast<const float4*>(m + first) + h) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int h = 0; h < kTqLane / 4; ++h) {
      wr[4 * h] = a[h].x, wr[4 * h + 1] = a[h].y, wr[4 * h + 2] = a[h].z, wr[4 * h + 3] = a[h].w;
      mr[4 * h] = b[h].x, mr[4 * h + 1] = b[h].y, mr[4 * h + 2] = b[h].z, mr[4 * h + 3] = b[h].w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kTqLane; ++k) {
      wr[k] = first + k < C ? w[first + k] : 0.0f;
      mr[k] = first + k < C ? m[first + k] : 0.0f;
    }
  }
}

// The midpoints cum - 0.5 w of the lane's centroids, the cumulative weight
// carried from the chunks before in ``icarry`` (exact groups, as an
// integer) or ``fcarry`` (others: f32 adds in centroid order, lane after
// lane); both carries advance past the chunk.
__device__ __forceinline__ void tq_midpoints(const float (&wr)[kTqLane], bool exact,
                                             unsigned int& icarry, float& fcarry, int lane,
                                             float (&cum)[kTqLane]) {
  float run[kTqLane];
  if (exact) {
    unsigned int lp[kTqLane], s = 0u;
#pragma unroll
    for (int k = 0; k < kTqLane; ++k) {
      s += (unsigned int)wr[k];
      lp[k] = s;
    }
    unsigned int incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned int t = __shfl_up_sync(kTqAll, incl, d);
      if (lane >= d) incl += t;
    }
    const unsigned int base = icarry + incl - s;
#pragma unroll
    for (int k = 0; k < kTqLane; ++k) run[k] = __uint2float_rn(base + lp[k]);
    icarry += __shfl_sync(kTqAll, incl, 31);
  } else {
    float r = fcarry;
    for (int L = 0; L < 32; ++L) {
      if (lane == L) {
#pragma unroll
        for (int k = 0; k < kTqLane; ++k) {
          r = __fadd_rn(r, wr[k]);
          run[k] = r;
        }
      }
      r = __shfl_sync(kTqAll, r, L);
    }
    fcarry = r;
  }
#pragma unroll
  for (int k = 0; k < kTqLane; ++k) cum[k] = __fsub_rn(run[k], __fmul_rn(0.5f, wr[k]));
}

// The running maximum of the non-empty centroids' midpoints through each of
// the lane's centroids (-inf before the first) into ``key``, from
// ``kcarry``, the chunks before's.
__device__ __forceinline__ void tq_keys(const float (&wr)[kTqLane], const float (&cum)[kTqLane],
                                        float kcarry, int lane, float (&key)[kTqLane]) {
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kTqLane; ++k) {
    mx = wr[k] > 0.0f ? fmaxf(mx, cum[k]) : mx;  // fmaxf drops a NaN midpoint
    key[k] = mx;
  }
  float before = __shfl_up_sync(kTqAll, mx, 1);  // the lanes before's maximum
  before = lane == 0 ? kcarry : fmaxf(before, kcarry);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(kTqAll, before, d);
    if (lane >= d) before = fmaxf(before, t);
  }
#pragma unroll
  for (int k = 0; k < kTqLane; ++k) key[k] = fmaxf(key[k], before);
}

// The midpoint and mean of centroid i (the same in every lane) into (cv, mv)
// when it lies in the chunk at c0, or is the chunk before's last (pc, pm);
// branch-free, every lane taking part in the shuffles.
__device__ __forceinline__ void tq_pick(int i, int c0, const float (&cum)[kTqLane],
                                        const float (&mr)[kTqLane], float pc, float pm,
                                        float& cv, float& mv) {
  const int r = i - c0;
  const int slot = r & (kTqLane - 1);
  float a = cum[0], b = mr[0];
#pragma unroll
  for (int k = 1; k < kTqLane; ++k) {
    a = slot == k ? cum[k] : a;
    b = slot == k ? mr[k] : b;
  }
  a = __shfl_sync(kTqAll, a, (r / kTqLane) & 31);
  b = __shfl_sync(kTqAll, b, (r / kTqLane) & 31);
  const bool in = r >= 0 && r < kTqChunk;
  cv = i == c0 - 1 ? pc : in ? a : cv;
  mv = i == c0 - 1 ? pm : in ? b : mv;
}

// CTA 0's first lane stamps clock64 into probe[k] (if given): 0 at the
// start, 1 after the checks, 2 after the midpoints, 3 after the searches,
// 4 after the stores.
__device__ __forceinline__ void tq_clock(long long* probe, int k) {
  if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) probe[k] = clock64();
}

template <bool kOne>  // kOne: the digest is one chunk, loaded once
__device__ __forceinline__ void tq_group(const float* __restrict__ w, const float* __restrict__ m,
                                         int C, bool vec, const float* __restrict__ qs, int Q,
                                         double* __restrict__ out, int lane, long long* probe) {
  const int nch = kOne ? 1 : (C + kTqChunk - 1) / kTqChunk;
  float wr[kTqLane], mr[kTqLane], cum[kTqLane], key[kTqLane];
  bool ok = true;
  unsigned int isum = 0u;  // the lane's whole weights, capped at 2^25
  int nv = 0;
  for (int c = 0; c < nch; ++c) {
    tq_load(w, m, C, vec, c * kTqChunk, lane, wr, mr);
#pragma unroll
    for (int k = 0; k < kTqLane; ++k) {
      const float x = wr[k];
      ok = ok && x >= 0.0f && x <= (float)kTqExact && x == truncf(x);
      isum = min(isum + (ok ? (unsigned int)x : 0u), 2u * kTqExact);
      nv += x > 0.0f;
    }
  }
  const unsigned int itotal = __reduce_add_sync(kTqAll, isum);  // at most 2^30
  const bool exact = __all_sync(kTqAll, ok) && itotal <= kTqExact;
  const int last_valid = max((int)__reduce_add_sync(kTqAll, (unsigned int)nv) - 1, 0);
  tq_clock(probe, 1);
  float total = __uint2float_rn(itotal);
  if (kOne) {
    unsigned int ic = 0u;
    float fc = 0.0f;
    tq_midpoints(wr, exact, ic, fc, lane, cum);
    tq_keys(wr, cum, -INFINITY, lane, key);
    if (!exact) total = fc;
  } else if (!exact) {
    unsigned int ic = 0u;
    float fc = 0.0f;
    for (int c = 0; c < nch; ++c) {
      tq_load(w, m, C, vec, c * kTqChunk, lane, wr, mr);
      tq_midpoints(wr, false, ic, fc, lane, cum);
    }
    total = fc;
  }
  tq_clock(probe, 2);
  for (int q0 = 0; q0 < Q; q0 += 32) {
    const int nq = min(Q - q0, 32);
    // lane j searches the block's j-th q: its centroid (hi) and the
    // midpoints and means at hi and its predecessor
    const float target = __fmul_rn(lane < nq ? qs[q0 + lane] : 0.0f, total);
    int hi = last_valid;
    bool found = false;
    float c_lo = 0.0f, c_hi = 0.0f, m_lo = 0.0f, m_hi = 0.0f;
    // the same at last_valid, for a q whose target no midpoint reaches
    float f_clo = 0.0f, f_chi = 0.0f, f_mlo = 0.0f, f_mhi = 0.0f;
    float pc = 0.0f, pm = 0.0f;  // the chunk before's last midpoint and mean
    float kcarry = -INFINITY;
    unsigned int ic = 0u;
    float fc = 0.0f;
    for (int c = 0; c < nch && __any_sync(kTqAll, lane < nq && !found); ++c) {
      const int c0 = c * kTqChunk;
      if (!kOne) {
        tq_load(w, m, C, vec, c0, lane, wr, mr);
        tq_midpoints(wr, exact, ic, fc, lane, cum);
        tq_keys(wr, cum, kcarry, lane, key);
      }
      tq_pick(last_valid, c0, cum, mr, pc, pm, f_chi, f_mhi);
      tq_pick(max(last_valid - 1, 0), c0, cum, mr, pc, pm, f_clo, f_mlo);
      kcarry = __shfl_sync(kTqAll, key[kTqLane - 1], 31);  // the chunk's largest key
      int pos = 0;  // the first lane whose last key reaches the target
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        pos += __shfl_sync(kTqAll, key[kTqLane - 1], pos + d - 1) < target ? d : 0;
      }
      int slot = 0;  // its keys below the target
      float a[kTqLane], b[kTqLane];
#pragma unroll
      for (int k = 0; k < kTqLane; ++k) {
        slot += __shfl_sync(kTqAll, key[k], pos) < target;
        a[k] = __shfl_sync(kTqAll, cum[k], pos);
        b[k] = __shfl_sync(kTqAll, mr[k], pos);
      }
      const float ac = __shfl_sync(kTqAll, cum[kTqLane - 1], (pos + 31) & 31);
      const float bc = __shfl_sync(kTqAll, mr[kTqLane - 1], (pos + 31) & 31);
      float chi = a[0], mhi = b[0];
      float clo = pos > 0 ? ac : c0 > 0 ? pc : a[0];  // slot 0's predecessor
      float mlo = pos > 0 ? bc : c0 > 0 ? pm : b[0];
#pragma unroll
      for (int k = 1; k < kTqLane; ++k) {
        chi = slot == k ? a[k] : chi;
        mhi = slot == k ? b[k] : mhi;
        clo = slot == k ? a[k - 1] : clo;
        mlo = slot == k ? b[k - 1] : mlo;
      }
      const bool now = !found && kcarry >= target;
      hi = now ? c0 + pos * kTqLane + slot : hi;
      c_lo = now ? clo : c_lo;
      c_hi = now ? chi : c_hi;
      m_lo = now ? mlo : m_lo;
      m_hi = now ? mhi : m_hi;
      found = found || now;
      pc = __shfl_sync(kTqAll, cum[kTqLane - 1], 31);
      pm = __shfl_sync(kTqAll, mr[kTqLane - 1], 31);
    }
    tq_clock(probe, 3);
    if (lane < nq) {  // each lane its q's interpolation
      c_lo = found ? c_lo : f_clo;
      c_hi = found ? c_hi : f_chi;
      m_lo = found ? m_lo : f_mlo;
      m_hi = found ? m_hi : f_mhi;
      const int lo = max(hi - 1, 0);
      float frac = c_hi > c_lo
                       ? __fdiv_rn(__fsub_rn(target, c_lo), fmaxf(__fsub_rn(c_hi, c_lo), 1e-9f))
                       : 1.0f;
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
      float v = __fadd_rn(m_lo, __fmul_rn(frac, __fsub_rn(m_hi, m_lo)));
      if (hi == lo) v = m_hi;
      out[q0 + lane] = total > 0.0f ? (double)v : 0.0;
    }
  }
  tq_clock(probe, 4);
}

__global__ void __launch_bounds__(kTqMaxWarps * 32)
    tdigest_quantiles_kernel(const float* __restrict__ means, const float* __restrict__ weights,
                             int G, int C, int vec, const float* __restrict__ qs, int Q,
                             double* __restrict__ out, long long* __restrict__ probe) {
  tq_clock(probe, 0);
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= G) return;  // a whole warp
  const float* w = weights + g * C;
  const float* m = means + g * C;
  if (C <= kTqChunk) {
    tq_group<true>(w, m, C, vec != 0, qs, Q, out + g * Q, lane, probe);
  } else {
    tq_group<false>(w, m, C, vec != 0, qs, Q, out + g * Q, lane, probe);
  }
}

// ---------------------------------------------------------------- H10
constexpr int kEstWarps = 8;  // groups a CTA: a warp a group

// A register's term of the estimate's sum, 2^-r, as an integer multiple of
// 2^-top (top = 33 - p, the largest register H5, H20 and the reference's
// _reg_rho keep): 2^(top - r). A group's sum of such terms is at most
// m * 2^top < 2^34, so the integer sum is exact and, scaled by 2^-top, it
// is the f64 sum of 2^-r in any order bit for bit.
__device__ __forceinline__ void est_term(int r, int top, unsigned long long& isum,
                                         unsigned int& zeros, bool& odd) {
  const bool ok = (unsigned int)r <= (unsigned int)top;
  isum += ok ? 1ull << (top - r) : 0ull;
  zeros += r == 0;
  odd |= !ok;
}

// A warp a group, eight groups a CTA of 256, no shared memory and no
// barrier: each lane reads its registers as 16-byte vectors (16 a lane at
// m = 2048, all issued before they are added), adds 2^(top - r) into a
// uint64 and counts the zeros, and five shuffle rounds add the lanes. A
// group holding a register outside [0, top] (no path makes one) adds
// ldexp(1, -r) in f64 instead, in a fixed order, in the same warp (its
// registers read again, from the L1). Lane 0
// then applies hll.py estimate's linear-counting and 2^32 large-range
// corrections in f64 and rounds half to even (jnp.round) as int64.
__global__ void __launch_bounds__(kEstWarps * 32)
    hll_estimate_kernel(const int* __restrict__ state, int S, int m, int top, int vec,
                        double alpha_m2, double* __restrict__ est,
                        long long* __restrict__ rounded) {
  constexpr unsigned int kAll = 0xFFFFFFFFu;
  constexpr int kBatch = 16;  // 16-byte loads in flight a lane: m = 2048 in one round
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kEstWarps + (threadIdx.x >> 5);
  if (g >= S) return;  // a whole warp
  const int* regs = state + g * m;
  unsigned long long isum = 0ull;
  unsigned int zeros = 0u;
  bool odd = false;
  if (vec) {
    const int4* q = reinterpret_cast<const int4*>(regs);
    const int nq = m >> 2;
    for (int c0 = 0; c0 < nq; c0 += 32 * kBatch) {
      int4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = c0 + b * 32 + lane;
        v[b] = c < nq ? __ldcs(q + c) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (c0 + b * 32 + lane < nq) {
          est_term(v[b].x, top, isum, zeros, odd);
          est_term(v[b].y, top, isum, zeros, odd);
          est_term(v[b].z, top, isum, zeros, odd);
          est_term(v[b].w, top, isum, zeros, odd);
        }
      }
    }
  } else {
    for (int j = lane; j < m; j += 32) est_term(regs[j], top, isum, zeros, odd);
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    isum += __shfl_xor_sync(kAll, isum, w);
    zeros += __shfl_xor_sync(kAll, zeros, w);
  }
  double s = ldexp((double)isum, -top);
  if (__any_sync(kAll, odd)) {
    // 2^-r as torch.pow(2.0, -r) gives it (inf below r = -1100, 0 above
    // 1100), added in f64 in a fixed order: each lane its 16-byte chunks
    // lane, lane + 32, ... (registers in order), then the shuffle rounds.
    s = 0.0;
    if (vec) {
      const int4* q = reinterpret_cast<const int4*>(regs);
      for (int c = lane; c < (m >> 2); c += 32) {
        const int4 v = q[c];
        const int r4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) s += ldexp(1.0, -max(min(r4[e], 1100), -1100));
      }
    } else {
      for (int j = lane; j < m; j += 32) s += ldexp(1.0, -max(min(regs[j], 1100), -1100));
    }
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) s += __shfl_xor_sync(kAll, s, w);
  }
  if (lane == 0) {
    const double md = (double)m;
    const double raw = alpha_m2 / s;
    const double z = (double)zeros;
    const double linear = md * log(fmax(md / fmax(z, 1e-9), 1.0));
    const bool use_linear = raw <= 2.5 * md && z > 0.0;
    const double two32 = 4294967296.0;
    const double large = -two32 * log(fmax(1.0 - fmin(raw, two32 * 0.9999) / two32, 1e-12));
    const double corrected = raw > two32 / 30.0 ? large : raw;
    const double e = use_linear ? linear : corrected;
    est[g] = e;
    rounded[g] = llrint(e);
  }
}

// ---------------------------------------------------------------- H30
__global__ void countmin_query_kernel(const long long* __restrict__ state, int G, int depth,
                                      int width, const int* __restrict__ gids,
                                      const unsigned long long* __restrict__ words, long long n,
                                      long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint32_t wmask = (uint32_t)width - 1u;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int g = gids[i];
    g = g < 0 ? 0 : (g >= G ? G - 1 : g);  // never read outside the state
    const uint2 h = px::hash32_pair(words[i], 1u);
    const long long* row = state + (long long)g * depth * width;
    long long best = row[h.x & wmask];
    for (int d = 1; d < depth; ++d) {
      const long long v = row[(long long)d * width + ((h.x + (uint32_t)d * h.y) & wmask)];
      best = v < best ? v : best;
    }
    out[i] = best;
  }
}

}  // namespace

extern "C" {

// out: u32 [n] (pair = 0) or [2, n] (pair = 1).
int px_hash32(const void* words, long long n, unsigned int seed, int pair, void* out,
              void* stream) {
  hash32_kernel<<<grid_for(n, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)words, n, seed, pair, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// H5. vals: [n] of ``kind`` (rows.cuh; offset ``off``); state: int32
// [S, 2^precision], updated in place. lane 0: shared registers; 1: one
// pass (ops/kernels/__init__.py hll_lane chooses).
int px_hll_update(const void* vals, int kind, long long off, long long n, const void* gids,
                  const void* mask, int S, int precision, void* state, int lane, void* stream) {
  HllArgs a;
  a.vals = vals;
  a.off = off;
  a.kind = kind;
  a.vec_vals = px::vec_aligned(vals, kind);
  a.vec = px::vec_aligned(gids, px::kI32) && (mask == nullptr || (uintptr_t)mask % 8 == 0);
  a.gids = (const int*)gids;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.S = S;
  a.precision = precision;
  a.state = (int*)state;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long threads = (n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  if (lane == 0) {
    const size_t smem = (size_t)S * ((size_t)1 << precision) * sizeof(int);
    cudaError_t err = allow_smem(hll_shared_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    hll_shared_kernel<<<grid_for(threads, 1), kThreads, smem, st>>>(a);
  } else {
    hll_onepass_kernel<<<grid_for(threads, 4), kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// H6. vals: [n] of ``kind`` (rows.cuh; offset ``off``, as H5's words);
// cm: int64 [S, depth, width] (width = 2^wbits) and total: int64 [S],
// updated in place. tbits: a CTA's table of 2^tbits slots, 0 for none
// (every row straight to its cells; needed past wbits 16, where a key no
// longer fits 64 bits; ops/kernels/__init__.py h6_table_bits chooses).
int px_countmin_update(const void* vals, int kind, long long off, long long n, const void* gids,
                       const void* mask, int S, int depth, int wbits, void* cm, void* total,
                       int tbits, void* stream) {
  if (S <= 0 || depth <= 0 || wbits < 0 || wbits > 30 || tbits < 0 || tbits > 16 ||
      (tbits > 0 && wbits > 16)) {
    return (int)cudaErrorInvalidValue;
  }
  CmArgs a;
  a.vals = vals;
  a.off = off;
  a.kind = kind;
  a.vec_vals = px::vec_aligned(vals, kind);
  a.vec = px::vec_aligned(gids, px::kI32) && (mask == nullptr || (uintptr_t)mask % 8 == 0);
  a.gids = (const int*)gids;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.S = S;
  a.depth = depth;
  a.wbits = wbits;
  a.cm = (unsigned long long*)cm;
  a.total = (unsigned long long*)total;
  a.tbits = tbits;
  const size_t table =
      (tbits > 0 ? (size_t)1 << tbits : 0) * (sizeof(unsigned long long) + sizeof(unsigned int));
  int optin = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  a.shared_totals = table + (size_t)S * sizeof(unsigned int) <= (size_t)optin;
  const size_t smem = table + (a.shared_totals ? (size_t)S * sizeof(unsigned int) : 0);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = allow_smem(countmin_table_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long want =
      ((n + px::kRowsPerThread - 1) / px::kRowsPerThread + kThreads - 1) / kThreads;
  // One CTA an SM with a table; without one, a wave of four.
  long long grid = (long long)px::num_sms() * (tbits > 0 ? 1 : 4);
  if (want < grid) grid = want > 0 ? want : 1;
  countmin_table_kernel<<<(int)grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// keys: u32 [n] (wide = 0) or int64 [n] (wide = 1); counts: int32 [G + 1],
// zeroed by the caller.
int px_tdigest_pack(const void* values, long long n, const void* gids, const void* mask, int G,
                    int bits_g, int wide, void* keys, void* counts, int counts_shared,
                    void* stream) {
  const size_t smem = counts_shared ? (size_t)(G + 1) * sizeof(int) : 0;
  cudaError_t err = allow_smem(tdigest_pack_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tdigest_pack_kernel<<<grid_for(n, 4), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values, n, (const int*)gids, (const unsigned char*)mask, G, bits_g, wide,
      keys, (int*)counts, counts_shared);
  return (int)cudaGetLastError();
}

// keys: H7a's keys, sorted; sums: f64 [2, G * C], zeroed by the caller.
// starts: int32 [G + 2] scratch, used above kTdSharedStarts groups.
int px_tdigest_cluster(const void* keys, long long n, const void* counts, int G, int C,
                       int bits_g, int wide, void* sums, void* starts, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool shared_starts = G + 2 <= kTdSharedStarts;
  if (!shared_starts) {
    if (starts == nullptr) return (int)cudaErrorInvalidValue;
    tdigest_starts_kernel<<<1, kTdThreads, 0, st>>>((const int*)counts, G, (int*)starts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = shared_starts ? (size_t)(G + 2) * sizeof(int) : 0;
  const int* starts_in = shared_starts ? nullptr : (const int*)starts;
  const int vec = (uintptr_t)keys % 16 == 0;
  const long long tile = (long long)kTdThreads * kTdVecs * (wide ? 2 : 4);
  long long grid = (n + tile - 1) / tile;
  const long long cap = (long long)px::num_sms() * 2;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  cudaError_t err;
  if (wide) {
    err = allow_smem(tdigest_cluster_kernel<unsigned long long>, smem);
    if (err != cudaSuccess) return (int)err;
    tdigest_cluster_kernel<unsigned long long><<<(int)grid, kTdThreads, smem, st>>>(
        (const unsigned long long*)keys, n, (const int*)counts, G, C, bits_g, vec, starts_in,
        (double*)sums);
  } else {
    err = allow_smem(tdigest_cluster_kernel<uint32_t>, smem);
    if (err != cudaSuccess) return (int)err;
    tdigest_cluster_kernel<uint32_t><<<(int)grid, kTdThreads, smem, st>>>(
        (const uint32_t*)keys, n, (const int*)counts, G, C, bits_g, vec, starts_in,
        (double*)sums);
  }
  return (int)cudaGetLastError();
}

// H8's CTA: a thread a key of the 2C, rounded up to whole warps, and 12
// words of shared memory a centroid.
static int td_merge_threads(int C) { return (2 * C + 31) / 32 * 32; }
static size_t td_merge_smem(int C) { return (size_t)12 * C * sizeof(uint32_t); }

// a_*: f32 [G, C]; b0/b1: f32 [G, C] means/weights, or with raw_b f64
// [G, C] weight/value sums; out_*: f32 [G, C].
int px_tdigest_merge(const void* a_means, const void* a_weights, const void* b0,
                     const void* b1, int raw_b, int G, int C, void* out_means,
                     void* out_weights, void* probe, void* stream) {
  if (G <= 0) return 0;
  if (C <= 0 || 2 * C > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = td_merge_smem(C);
  cudaError_t err = allow_smem(tdigest_merge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tdigest_merge_kernel<<<G, td_merge_threads(C), smem, (cudaStream_t)stream>>>(
      (const float*)a_means, (const float*)a_weights, b0, b1, raw_b, C, (float*)out_means,
      (float*)out_weights, (long long*)probe);
  return (int)cudaGetLastError();
}

// H8's launch shape: out[0] CTAs, out[1] threads a CTA, out[2] bytes of
// dynamic shared memory a CTA.
int px_tdigest_merge_geometry(int G, int C, int* out) {
  out[0] = G;
  out[1] = td_merge_threads(C);
  out[2] = (int)td_merge_smem(C);
  return 0;
}

// out: f64 [G, Q]; probe: null or int64 [5], CTA 0's clock64 phases.
int px_tdigest_quantiles(const void* means, const void* weights, int G, int C, const void* qs,
                         int Q, void* out, void* probe, void* stream) {
  if (G <= 0 || Q <= 0) return 0;
  const int vec = C % 4 == 0 && (uintptr_t)means % 16 == 0 && (uintptr_t)weights % 16 == 0;
  const int warps = tq_warps(G);
  tdigest_quantiles_kernel<<<(G + warps - 1) / warps, warps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)means, (const float*)weights, G, C, vec, (const float*)qs, Q, (double*)out,
      (long long*)probe);
  return (int)cudaGetLastError();
}

// out: {CTAs, threads a CTA, dynamic shared bytes} of px_tdigest_quantiles'
// launch over G groups on the current device.
int px_tdigest_quantiles_geometry(int G, int* out) {
  const int warps = tq_warps(max(G, 1));
  out[0] = G > 0 ? (G + warps - 1) / warps : 0;
  out[1] = warps * 32;
  out[2] = 0;
  return 0;
}

// state: int32 [S, m]; est: f64 [S]; rounded: int64 [S]. p = floor(log2 m):
// registers in [0, 33 - p] take the integer sum.
int px_hll_estimate(const void* state, int S, int m, int p, double alpha_m2, void* est,
                    void* rounded, void* stream) {
  if (S <= 0) return 0;
  const int vec = m % 4 == 0 && (uintptr_t)state % 16 == 0;
  hll_estimate_kernel<<<(S + kEstWarps - 1) / kEstWarps, kEstWarps * 32, 0,
                        (cudaStream_t)stream>>>((const int*)state, S, m, 33 - p, vec, alpha_m2,
                                                (double*)est, (long long*)rounded);
  return (int)cudaGetLastError();
}

// out: {CTAs, threads a CTA, dynamic shared bytes} of px_hll_estimate's
// launch over S groups.
int px_hll_estimate_geometry(int S, int* out) {
  out[0] = S > 0 ? (S + kEstWarps - 1) / kEstWarps : 0;
  out[1] = kEstWarps * 32;
  out[2] = 0;
  return 0;
}

// state: int64 [G, depth, width] (width a power of two); gids int32 [n];
// words: the values' 64-bit words [n]; out: int64 [n].
int px_countmin_query(const void* state, int G, int depth, int width, const void* gids,
                      const void* words, long long n, void* out, void* stream) {
  countmin_query_kernel<<<grid_for(n, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)state, G, depth, width, (const int*)gids,
      (const unsigned long long*)words, n, (long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
