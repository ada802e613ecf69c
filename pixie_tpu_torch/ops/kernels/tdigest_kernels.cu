// The t-digest's block update without a sort (K12's packed lane), built for
// Hopper (sm_90a) with the other kernel sources into one shared library that
// has a plain C interface (ops/kernels/__init__.py builds and binds it). It
// launches on the CUDA runtime's current device and the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// H7 px_tdigest_update  replaces pixie_tpu/ops/tdigest.py _packed_sort (:56,
//    the key packing and its jnp.sort) and the rank, k1 cluster and
//    per-cluster sums of update (:78) for up to 254 groups: the f64 [2, G, C]
//    row counts and value sums of each (group, cluster) that H8 merges.
//    Above 254 groups the port keeps H7a, torch.sort and H7b.
//
// What the design rests on. A row's cluster depends only on its rank r in
// its group and the group's count n, cluster((r + 0.5) / n); rows of equal
// packed keys have equal values (the value is rebuilt from its key). So a
// block's sums need each group's keys only at the ranks where the cluster
// changes (the run starts, about C a group), not a full order.
//
// One cooperative launch (one CTA an SM, grid-wide barriers between the
// phases; the same work as H7a + torch.sort + H7b, and all its zeroing):
//  (a) pack: each row's key u = order_key(v) >> bits_g (W = 32 - bits_g
//      bits) and group (G for a masked row or a gid outside [0, G)) into a
//      u32 (g << W | u), written for the later passes (8 MB at 2^21 rows:
//      they stay in the L2); a level-1 histogram of u's top b1 bits a group
//      in shared memory (b1 chosen so that G << b1 counts fit; shared
//      atomics as they come: joining equal bins across a warp first cost
//      more than it saved), flushed into global counts, scanned a group.
//  (b) run starts from the counts alone: the cluster at every rank of every
//      group, the ranks where it changes; each run start's level-1 bin, and
//      a slot for each level-1 bin that holds one (a count a group).
//  (c) select: the key at each run start by two more histogram levels (b2,
//      then b3 bits), each only over the rows whose bin at the level before
//      holds a run start (global atomics, equal bins joined across a warp by
//      __match_any_sync against skewed keys; the level-3 pass reads a bitmap
//      of the level-2 bins that hold one); this also gives lt (keys below)
//      and eq (keys equal) of each selected key.
//  (d) add up: each group's runs in rank order; a run's weight is its rank
//      span, its selected keys' ties split across the runs they cover (m
//      rows add m * x, exact in f64); every other row binary-searches its
//      group's selected keys (in shared memory) and adds its value to the run
//      of the largest selected key below it, into a CTA's f64 partial in
//      shared memory (few groups) or the output; the CTAs' partials are then
//      added in CTA order.
//
// The cluster of a rank is the plain version's arithmetic (ops/tdigest.py
// _row_clusters, _cluster_ids): f32 rank + 0.5, the division by the count,
// the clip, 2q - 1, asin in f64 rounded to f32 (CUDA's asin(double), which
// torch's CUDA asin of a double tensor is too), / pi + 0.5, * C, floor,
// clip; each f32 step rounds on its own. So the weights equal the plain
// version's on the card bit for bit, and the cluster is monotone in the
// rank: f32 inputs a ulp apart give asin values far more than f64's error
// apart. A run start is still looked for at every rank; its run is kept at
// slot g * C + cluster, so a cluster that came back would meet its own
// earlier run and trap.
//
// What bounds it on an H100: bytes, the values, gids and mask read once and
// the [2, G, C] sums written once (the packed keys' write and re-reads stay
// in the L2). The passes it takes above that: the level-2 pass's global
// atomics (one a row in a bin that holds a run start: nearly every row of
// exponential latencies at 2^11 level-1 bins a group), the final pass's f64
// adds, and the grid barriers between the phases.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tdigest_cluster.cuh"

namespace {

constexpr int kTuThreads = 1024;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr int kLine = 32;  // u32 words of a 128-byte line

struct TuArgs {
  const void* values;
  int f64;  // values are f64 (rounded to f32 as torch's .to(float32)), else f32
  const int* gids;
  const unsigned char* mask;
  long long n;
  int G, C, bits_g, W, b1, b2, b3;
  int spg1;           // level-2 slots a group: min(2^b1, C)
  int vec;            // values, gids and mask take 16-, 16- and 4-byte vector loads
  int shared_sums;    // the final pass's value sums in a CTA's shared partial
  int region_words;   // shared words before the starts
  // scratch, carved by px_tdigest_update
  double* partials;  // [grid][G * C] with shared_sums
  uint32_t* keys;    // [n]
  uint32_t* cum1;    // [G << b1]: counts, then their exclusive scan a group
  uint32_t* map1;    // [G << b1]: level-2 slot + 1 of a bin holding a run start
  uint32_t* gcount;  // [G]
  uint32_t* ctr;     // [4]: the most runs a group
  uint32_t* slot1_n;  // [G * kLine]: a group's level-2 slots (a line each)
  uint32_t* slot2_n;  // [G * kLine]: a group's level-3 slots
  uint32_t* run_n;    // [G * kLine]: a group's runs
  uint32_t* run_rank;  // each [G * C]: the run of cluster c of group g at g * C + c
  uint32_t* run_cnt;   // the run starts of the cluster: one (a cluster that came back traps)
  uint32_t* run_b;     // the run start's bin at the level being resolved
  uint32_t* run_t;     // its rank within that bin
  uint32_t* run_key;
  uint32_t* run_lt;
  uint32_t* run_eq;
  uint32_t* ord_key;  // [G * C]: the selected keys in rank order
  uint32_t* ord_cl;
  uint32_t* hist2;  // [G * spg1 << b2]: level-2 counts of slot g * spg1 + j
  uint32_t* map2;   // [G * spg1 << b2]: level-3 slot + 1 of a bin holding a run start
  uint32_t* bits2;  // [G * spg1 << b2 / 32]: those bins, by compact level-2 slot
  uint32_t* hist3;  // [G * C << b3]: level-3 counts of slot g * C + j
  double* sums;  // out: [2][G * C]
  unsigned int* bar;  // [2]: arrivals, generation
  long long* stamps;  // null, or [16]: the phases' end times (ns), then the slots
};

// The device clock (ns) at the end of phase k, by CTA 0 (after the grid
// barrier that ends it), when the caller asked for the phases' times.
__device__ __forceinline__ void stamp(const TuArgs& a, int k) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[k] = (long long)t;
  }
}

// The order-preserving u32 map of an f32's bits and its inverse (the same
// as sketch_kernels.cu's H7a).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t mp) {
  return __uint_as_float((mp >> 31) ? (mp & 0x7FFFFFFFu) : ~mp);
}

// The cluster of rank r in a group of cnt rows, step by step as
// ops/tdigest.py _row_clusters and _cluster_ids compute it: f32 rank + 0.5,
// the division by the count, then tdigest_cluster.cuh's td_q_cluster.
__device__ __forceinline__ int rank_cluster(uint32_t r, uint32_t cnt, int C) {
  const float rank = __uint2float_rn(r);
  const float c = __uint2float_rn(cnt);
  return px::td_q_cluster(__fdiv_rn(__fadd_rn(rank, 0.5f), fmaxf(c, 1.0f)), C);
}

// rank_cluster without its divisions where that is safe: the coordinate
// (asinf(2 (r + 0.5) / cnt - 1) / pi + 0.5) C from a reciprocal and
// products lies within 0.06 of the exact steps' (the reciprocal's and the
// product's rounding move q by at most 1.8e-7 q, x = 2q - 1 by 4.2e-7,
// which asin's slope, at most 1581 inside the clip, and C / pi turn into
// 2.1e-4 C, 0.055 at C = 256; the f32 roundings after it add 1e-4); so a
// coordinate at least max(0.1, 4e-4 C) from an integer is the exact steps'
// cluster, and any other takes rank_cluster.
__device__ __forceinline__ int rank_cluster_fast(uint32_t r, uint32_t cnt, float inv, int C) {
  float q = __fmul_rn(__fadd_rn(__uint2float_rn(r), 0.5f), inv);
  q = fminf(fmaxf(q, 1e-7f), (float)(1.0 - 1e-7));
  const float y = (asinf(2.0f * q - 1.0f) * (1.0f / px::kTdPiF) + 0.5f) * (float)C;
  const float f = y - floorf(y);
  const float m = fmaxf(0.1f, 4e-4f * (float)C);  // the bound above scales with C
  if (f > m && f < 1.0f - m) return min(max((int)floorf(y), 0), C - 1);
  return rank_cluster(r, cnt, C);
}

// A grid-wide barrier of a cooperative launch (every CTA resident): the
// last CTA to arrive resets the count and bumps the generation the others
// wait on. Each CTA's writes before it are visible to every CTA after it.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == seen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Adds one a lane at base[addr]: lanes with equal addr are joined by
// __match_any_sync, and the lowest adds their count. addr kNone adds
// nothing. Every lane of the warp calls it.
__device__ __forceinline__ void warp_count(uint32_t* base, uint32_t addr) {
  const unsigned int peers = __match_any_sync(0xFFFFFFFFu, addr);
  if (addr != kNone && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(base + addr, (uint32_t)__popc(peers));
  }
}

// The first index in [0, len) whose value (in shared memory) is above x
// (len if none).
__device__ __forceinline__ uint32_t upper_bound(const uint32_t* v, uint32_t len, uint32_t x) {
  uint32_t lo = 0, hi = len;
  while (lo < hi) {
    const uint32_t mid = (lo + hi) >> 1;
    if (v[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The bin of a warp's histogram row of 32 * PER counts (read from the L2 as
// 16-byte vectors) that holds rank t of the row's rows, and the rows in
// bins before it: every lane takes PER consecutive bins, and the lane whose
// span holds t walks them. Returns (bin, below) in every lane.
template <int PER>
__device__ __forceinline__ void warp_find(const uint32_t* row, uint32_t t, uint32_t* bin,
                                          uint32_t* below) {
  const int lane = threadIdx.x & 31;
  uint32_t x[PER];
#pragma unroll
  for (int k = 0; k < PER / 4; ++k) {
    const uint4 w = __ldcg(reinterpret_cast<const uint4*>(row + lane * PER) + k);
    x[4 * k] = w.x;
    x[4 * k + 1] = w.y;
    x[4 * k + 2] = w.z;
    x[4 * k + 3] = w.w;
  }
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) sum += x[k];
  uint32_t incl = sum;  // inclusive warp scan of the lanes' sums
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  uint32_t b = kNone, bl = 0, c = incl - sum;
  if (c <= t && t < incl) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (b == kNone && t < c + x[k]) {
        b = lane * PER + k;
        bl = c;
      }
      c += x[k];
    }
  }
  const unsigned int who = __ballot_sync(0xFFFFFFFFu, b != kNone);
  const int src = who ? __ffs(who) - 1 : 0;
  *bin = __shfl_sync(0xFFFFFFFFu, b, src);
  *below = __shfl_sync(0xFFFFFFFFu, bl, src);
}

// len (a multiple of 4) zero words at p (16-byte aligned), as vectors.
__device__ __forceinline__ void zero_words(uint32_t* p, uint32_t len) {
  for (uint32_t k = 0; k < len / 4; ++k) reinterpret_cast<uint4*>(p)[k] = make_uint4(0u, 0u, 0u, 0u);
}

// n words (a multiple of 4, 16-byte aligned) from global memory (read from
// the L2) into shared memory, 16-byte vectors, four in flight a thread.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src, uint32_t n) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const uint32_t n4 = n / 4;
  for (uint32_t k = threadIdx.x; k < n4; k += 4 * blockDim.x) {
    uint4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t i = k + q * blockDim.x;
      if (i < n4) v[q] = __ldcg(s4 + i);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t i = k + q * blockDim.x;
      if (i < n4) d4[i] = v[q];
    }
  }
}

// Claims a slot for a bin of group g: the first caller for map[idx] takes
// the group's next slot (its count on a line of its own; slot g * per + j),
// zeroes that slot's row of the next level's counts (len words at hist +
// slot * len) and of nmap if given, and publishes slot + 1; later callers
// only see it taken. The rows are read only after the grid barrier that
// ends the phase.
__device__ __forceinline__ void claim(uint32_t* map, uint32_t idx, uint32_t* group_n, int g,
                                      uint32_t per, uint32_t* hist, uint32_t* nmap,
                                      uint32_t len) {
  if (atomicCAS(map + idx, 0u, kNone) != 0u) return;
  const uint32_t j = atomicAdd(group_n + (size_t)g * kLine, 1u);
  if (j >= per) __trap();
  const uint32_t s = (uint32_t)g * per + j;
  zero_words(hist + (size_t)s * len, len);
  if (nmap != nullptr) zero_words(nmap + (size_t)s * len, len);
  atomicExch(map + idx, s + 1u);
}

// Rows i0 .. i0 + 3 of the packed keys (kNone past n: its group is above
// G), as one 16-byte vector where they are whole.
__device__ __forceinline__ void load_keys4(const uint32_t* keys, long long i0, long long n,
                                          uint32_t (&p)[4]) {
  if (i0 + 4 <= n) {
    const uint4 w = __ldcg(reinterpret_cast<const uint4*>(keys + i0));
    p[0] = w.x;
    p[1] = w.y;
    p[2] = w.z;
    p[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = i0 + j < n ? __ldcg(keys + i0 + j) : kNone;
  }
}

__global__ void __launch_bounds__(kTuThreads, 1) tdigest_update_kernel(const TuArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, T = blockDim.x;
  const long long gthreads = (long long)gridDim.x * T;
  const long long gtid = (long long)blockIdx.x * T + tid;
  const int warp = (int)(gtid >> 5), gwarps = (int)(gthreads >> 5);
  const int G = a.G, C = a.C, W = a.W, b1 = a.b1, b2 = a.b2, b3 = a.b3;
  const uint32_t L1 = (uint32_t)G << b1, B1 = 1u << b1, B2 = 1u << b2, B3 = 1u << b3;
  const uint32_t spg1 = (uint32_t)a.spg1;
  const uint32_t umask = (1u << W) - 1u;
  const int sh1 = W - b1;  // u >> sh1: the level-1 bin
  const long long GC = (long long)G * C;
  uint32_t* region = sm;                    // phase-dependent
  uint32_t* starts = sm + a.region_words;  // [G + 1]
  uint32_t* run_n = starts + G + 1;         // [G]
  uint32_t* off1 = run_n + G;               // [G + 1]: the compact level-2 slots' starts
  uint32_t* tmp = off1 + G + 1;             // [65]: a block scan's sums
  // A thread's rows in every pass are i0 .. i0 + 3, i0 = 4 (gtid + k
  // gthreads): every lane of a warp runs the same trips (the warp-wide joins
  // need them all).
  const long long trips = ((a.n + 3) / 4 + gthreads - 1) / gthreads;
  stamp(a, 0);

  // ---- (a) zero the scratch and the output; pack; level-1 counts in
  // shared memory, flushed into global counts.
  for (long long i = gtid; i < L1; i += gthreads) {
    a.cum1[i] = 0u;
    a.map1[i] = 0u;
  }
  for (long long i = gtid; i < G; i += gthreads) {
    a.slot1_n[i * kLine] = 0u;
    a.slot2_n[i * kLine] = 0u;
  }
  for (long long i = gtid; i < GC; i += gthreads) {
    a.run_rank[i] = kNone;
    a.run_cnt[i] = 0u;
  }
  for (long long i = gtid; i < (((long long)G * spg1) << b2) / 32; i += gthreads) a.bits2[i] = 0u;
  if (gtid < 4) a.ctr[gtid] = 0u;
  for (long long i = gtid; i < 2 * GC; i += gthreads) a.sums[i] = 0.0;
  for (uint32_t i = tid; i < L1; i += T) region[i] = 0u;
  __syncthreads();
  for (long long k = 0; k < trips; ++k) {
    const long long i0 = 4 * (gtid + k * gthreads);
    int g[4];
    float v[4];
    bool m[4];
    if (a.vec && i0 + 4 <= a.n) {
      const int4 gg = __ldcs(reinterpret_cast<const int4*>(a.gids + i0));
      g[0] = gg.x; g[1] = gg.y; g[2] = gg.z; g[3] = gg.w;
      if (a.f64) {
        const double2* d = reinterpret_cast<const double2*>((const double*)a.values + i0);
        const double2 d0 = __ldcs(d), d1 = __ldcs(d + 1);
        v[0] = __double2float_rn(d0.x); v[1] = __double2float_rn(d0.y);
        v[2] = __double2float_rn(d1.x); v[3] = __double2float_rn(d1.y);
      } else {
        const float4 f = __ldcs(reinterpret_cast<const float4*>((const float*)a.values + i0));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
      const uint32_t mm = a.mask ? __ldcs(reinterpret_cast<const unsigned int*>(a.mask + i0))
                                 : 0x01010101u;
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = ((mm >> (8 * j)) & 0xFFu) != 0u;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = i0 + j;
        m[j] = i < a.n && (a.mask == nullptr || a.mask[i] != 0);
        g[j] = i < a.n ? a.gids[i] : -1;
        v[j] = i >= a.n ? 0.0f
               : a.f64 ? __double2float_rn(((const double*)a.values)[i])
                       : ((const float*)a.values)[i];
      }
    }
    uint32_t p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = m[j] && g[j] >= 0 && g[j] < G;
      const uint32_t u = order_key(v[j]) >> a.bits_g;
      p[j] = ((uint32_t)(ok ? g[j] : G) << W) | u;
      // Shared atomics as they come: joining equal bins across a warp first
      // (__match_any_sync) cost more than it saved at exponential latencies.
      if (ok) atomicAdd(region + (((uint32_t)g[j] << b1) | (u >> sh1)), 1u);
    }
    if (i0 + 4 <= a.n) {
      *reinterpret_cast<uint4*>(a.keys + i0) = make_uint4(p[0], p[1], p[2], p[3]);
    } else {
      for (int j = 0; j < 4 && i0 + j < a.n; ++j) a.keys[i0 + j] = p[j];
    }
  }
  grid_sync(a.bar);
  stamp(a, 1);
  for (uint32_t i = tid; i < L1; i += T) {
    if (region[i] != 0u) atomicAdd(a.cum1 + i, region[i]);
  }
  grid_sync(a.bar);
  stamp(a, 2);

  // Each group's level-1 counts, scanned in place by one CTA a group.
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    uint32_t* row = a.cum1 + ((size_t)g << b1);
    const uint32_t per = (B1 + T - 1) / T;
    uint32_t local = 0;
    for (uint32_t k = 0; k < per; ++k) {
      const uint32_t b = tid * per + k;
      if (b < B1) local += __ldcg(row + b);
    }
    uint32_t incl = local;  // block-wide exclusive scan of the threads' sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) tmp[tid >> 5] = incl;
    __syncthreads();
    if (tid < 32) {
      const uint32_t w = tid < (T >> 5) ? tmp[tid] : 0u;
      uint32_t wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, wi, d);
        if (lane >= d) wi += up;
      }
      tmp[32 + tid] = wi - w;
      if (tid == 31) tmp[64] = wi;
    }
    __syncthreads();
    uint32_t c = tmp[32 + (tid >> 5)] + incl - local;
    for (uint32_t k = 0; k < per; ++k) {
      const uint32_t b = tid * per + k;
      if (b < B1) {
        const uint32_t x = __ldcg(row + b);
        row[b] = c;
        c += x;
      }
    }
    if (tid == 0) a.gcount[g] = tmp[64];
    __syncthreads();
  }
  grid_sync(a.bar);
  stamp(a, 3);

  // ---- (b) run starts. Every CTA scans the group counts into its starts
  // and copies the level-1 scans.
  for (int g = tid; g < G; g += T) starts[g] = __ldcg(a.gcount + g);
  copy_words(region, a.cum1, L1);
  __syncthreads();
  if (tid == 0) {
    uint32_t s = 0;
    for (int g = 0; g < G; ++g) {
      const uint32_t c = starts[g];
      starts[g] = s;
      s += c;
    }
    starts[G] = s;
  }
  __syncthreads();
  {
    const uint32_t live = starts[G];
    constexpr uint32_t kRanks = 8;  // consecutive ranks a thread
    const long long chunks = (live + kRanks - 1) / kRanks;
    for (long long ch = gtid; ch < chunks; ch += gthreads) {
      const uint32_t i0 = (uint32_t)ch * kRanks;
      int g = (int)upper_bound(starts, G + 1, i0) - 1;
      uint32_t n_g = starts[g + 1] - starts[g];
      float inv = 1.0f / fmaxf(__uint2float_rn(n_g), 1.0f);
      int prev = i0 > starts[g] ? rank_cluster_fast(i0 - 1 - starts[g], n_g, inv, C) : -1;
      const uint32_t i1 = min(i0 + kRanks, live);
      for (uint32_t i = i0; i < i1; ++i) {
        while (i >= starts[g + 1]) {
          ++g;
          n_g = starts[g + 1] - starts[g];
          inv = 1.0f / fmaxf(__uint2float_rn(n_g), 1.0f);
          prev = -1;
        }
        const uint32_t r = i - starts[g];
        const int cl = rank_cluster_fast(r, n_g, inv, C);
        if (cl == prev) continue;
        prev = cl;
        // The run of cluster cl; a second run start of it (a cluster that
        // came back: never, the cluster being monotone in the rank) traps
        // in (d).
        const size_t idx = (size_t)g * C + cl;
        const uint32_t* row = region + ((size_t)g << b1);
        const uint32_t b = upper_bound(row, B1, r) - 1;
        const uint32_t gb = ((uint32_t)g << b1) | b;
        atomicAdd(a.run_cnt + idx, 1u);
        a.run_rank[idx] = r;
        a.run_b[idx] = gb;
        a.run_t[idx] = r - row[b];
        a.run_key[idx] = b << sh1;
        a.run_lt[idx] = row[b];
        claim(a.map1, gb, a.slot1_n, g, spg1, a.hist2, a.map2, B2);
      }
    }
  }
  grid_sync(a.bar);
  stamp(a, 4);

  // ---- (c) level 2: the rows of level-1 bins that hold a run start. Each
  // CTA copies the slots and scans the groups' slot counts into off1.
  copy_words(region, a.map1, L1);
  for (int g = tid; g < G; g += T) off1[g] = __ldcg(a.slot1_n + (size_t)g * kLine);
  __syncthreads();
  if (tid == 0) {
    uint32_t s = 0;
    for (int g = 0; g < G; ++g) {
      const uint32_t c = off1[g];
      off1[g] = s;
      s += c;
    }
    off1[G] = s;
  }
  __syncthreads();
  for (long long k = 0; k < trips; ++k) {
    uint32_t p[4];
    load_keys4(a.keys, 4 * (gtid + k * gthreads), a.n, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t g = p[j] >> W, u = p[j] & umask;
      const uint32_t s = g < (uint32_t)G ? region[(g << b1) | (u >> sh1)] : 0u;
      warp_count(a.hist2, s != 0u ? ((s - 1u) << b2) | ((u >> b3) & (B2 - 1u)) : kNone);
    }
  }
  grid_sync(a.bar);
  stamp(a, 5);

  // Each run start's level-2 bin, a warp a run; the bin's bit in the bitmap
  // by its compact level-2 slot.
  for (int w = warp; w < GC; w += gwarps) {
    if (__ldcg(a.run_rank + w) == kNone) continue;
    const int g = w / C;
    const uint32_t s1 = __ldcg(a.map1 + __ldcg(a.run_b + w)) - 1u;
    const uint32_t t = __ldcg(a.run_t + w);
    uint32_t bin, below;
    warp_find<8>(a.hist2 + ((size_t)s1 << b2), t, &bin, &below);  // b2 = 8
    if (lane == 0) {
      const uint32_t b = (s1 << b2) | bin;
      const uint32_t c = ((off1[g] + s1 - (uint32_t)g * spg1) << b2) | bin;
      a.run_b[w] = b;
      a.run_t[w] = t - below;
      a.run_lt[w] = __ldcg(a.run_lt + w) + below;
      a.run_key[w] = __ldcg(a.run_key + w) | (bin << b3);
      atomicOr(a.bits2 + (c >> 5), 1u << (c & 31));
      claim(a.map2, b, a.slot2_n, g, (uint32_t)C, a.hist3, nullptr, B3);
    }
  }
  grid_sync(a.bar);
  stamp(a, 6);

  // ---- level 3: the rows of level-2 bins that hold a run start (the
  // level-1 slots are still in shared memory, and beside them, while it
  // fits, the bitmap of those level-2 bins: a row outside them reads no
  // level-3 slot).
  const uint32_t bm_words = (off1[G] << b2) / 32;
  uint32_t* bm = L1 + bm_words <= (uint32_t)a.region_words ? region + L1 : nullptr;
  if (bm != nullptr) copy_words(bm, a.bits2, (bm_words + 3) & ~3u);
  __syncthreads();
  for (long long k = 0; k < trips; ++k) {
    uint32_t p[4], s2[4];
    load_keys4(a.keys, 4 * (gtid + k * gthreads), a.n, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t g = p[j] >> W, u = p[j] & umask;
      const uint32_t s = g < (uint32_t)G ? region[(g << b1) | (u >> sh1)] : 0u;
      const uint32_t lo = (u >> b3) & (B2 - 1u);
      const uint32_t c = s != 0u ? ((off1[g] + s - 1u - g * spg1) << b2) | lo : 0u;
      const bool on = s != 0u && (bm == nullptr || ((bm[c >> 5] >> (c & 31)) & 1u) != 0u);
      s2[j] = on ? __ldcg(a.map2 + (((s - 1u) << b2) | lo)) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      warp_count(a.hist3, s2[j] != 0u ? ((s2[j] - 1u) << b3) | (p[j] & (B3 - 1u)) : kNone);
    }
  }
  grid_sync(a.bar);
  stamp(a, 7);

  // Each run start's key, lt and eq, a warp a run.
  for (int w = warp; w < GC; w += gwarps) {
    if (__ldcg(a.run_rank + w) == kNone) continue;
    const uint32_t s2 = __ldcg(a.map2 + __ldcg(a.run_b + w)) - 1u;
    const uint32_t* row = a.hist3 + ((size_t)s2 << b3);
    uint32_t bin, below;
    if (b3 == 8) warp_find<8>(row, __ldcg(a.run_t + w), &bin, &below);
    else warp_find<16>(row, __ldcg(a.run_t + w), &bin, &below);  // b3 = 9
    if (lane == 0) {
      a.run_key[w] = __ldcg(a.run_key + w) | bin;
      a.run_lt[w] = __ldcg(a.run_lt + w) + below;
      a.run_eq[w] = __ldcg(row + bin);
    }
  }
  grid_sync(a.bar);
  stamp(a, 8);

  // ---- (d) each group's runs in rank order (a CTA a group): weights,
  // and the selected keys' ties split across the runs they cover.
  {
    uint32_t* rk = region;  // [C] each: unordered, then ordered
    uint32_t* cl = rk + C;
    uint32_t* ky = cl + C;
    uint32_t* lt = ky + C;
    uint32_t* eq = lt + C;
    uint32_t* ork = eq + C;
    uint32_t* ocl = ork + C;
    uint32_t* oky = ocl + C;
    uint32_t* olt = oky + C;
    uint32_t* oeq = olt + C;
    for (int g = blockIdx.x; g < G; g += gridDim.x) {
      const size_t base = (size_t)g * C;
      if (tid == 0) tmp[0] = 0u;
      __syncthreads();
      for (int j = tid; j < C; j += T) {  // the group's runs, in any order
        const uint32_t r = __ldcg(a.run_rank + base + j);
        if (r == kNone) continue;
        if (__ldcg(a.run_cnt + base + j) != 1u) __trap();  // a cluster came back
        const uint32_t q = atomicAdd(tmp, 1u);
        rk[q] = r;
        cl[q] = (uint32_t)j;
        ky[q] = __ldcg(a.run_key + base + j);
        lt[q] = __ldcg(a.run_lt + base + j);
        eq[q] = __ldcg(a.run_eq + base + j);
      }
      __syncthreads();
      const int m = (int)tmp[0];
      if (tid == 0) {
        a.run_n[(size_t)g * kLine] = (uint32_t)m;
        atomicMax(a.ctr, (uint32_t)m);
      }
      for (int j = tid; j < m; j += T) {  // ranks within a group are distinct
        int pos = 0;
        for (int q = 0; q < m; ++q) pos += rk[q] < rk[j];
        ork[pos] = rk[j];
        ocl[pos] = cl[j];
        oky[pos] = ky[j];
        olt[pos] = lt[j];
        oeq[pos] = eq[j];
      }
      __syncthreads();
      const uint32_t n_g = starts[g + 1] - starts[g];
      for (int j = tid; j < m; j += T) {
        const uint32_t s0 = ork[j], s1 = j + 1 < m ? ork[j + 1] : n_g;
        const long long cell = (long long)g * C + ocl[j];
        atomicAdd(a.sums + cell, (double)(s1 - s0));
        const uint32_t lo = max(s0, olt[j]), hi = min(s1, olt[j] + oeq[j]);
        if (hi > lo) {
          const double x = (double)from_order_key(oky[j] << a.bits_g);
          atomicAdd(a.sums + GC + cell, __dmul_rn((double)(hi - lo), x));
        }
        if (j + 1 < m && oky[j + 1] != oky[j]) {
          const uint32_t lo2 = max(s0, olt[j + 1]), hi2 = min(s1, olt[j + 1] + oeq[j + 1]);
          if (hi2 > lo2) {
            const double x = (double)from_order_key(oky[j + 1] << a.bits_g);
            atomicAdd(a.sums + GC + cell, __dmul_rn((double)(hi2 - lo2), x));
          }
        }
        a.ord_key[base + j] = oky[j];
        a.ord_cl[base + j] = ocl[j];
      }
      __syncthreads();
    }
  }
  grid_sync(a.bar);
  stamp(a, 9);

  // ---- the other rows: the run of the largest selected key below theirs,
  // found in the group's selected keys: in shared memory while they fit, a
  // row of (most runs a group) + 1 words a group (the groups' searches fall
  // in distinct banks), else in the scratch.
  double* sh_sums = reinterpret_cast<double*>(region);  // [G * C] with shared_sums
  const int maxm = (int)__ldcg(a.ctr);
  const long long sums_words = a.shared_sums ? 2 * GC : 0;
  const bool klists_shared = sums_words + 2ll * G * (maxm + 1) <= a.region_words;
  const int ks = klists_shared ? maxm + 1 : C;
  uint32_t* kbase = klists_shared ? region + sums_words : a.ord_key;
  uint32_t* cbase = klists_shared ? kbase + (size_t)G * ks : a.ord_cl;
  for (int g = tid; g < G; g += T) run_n[g] = __ldcg(a.run_n + (size_t)g * kLine);
  if (a.shared_sums) {
    for (long long c = tid; c < GC; c += T) sh_sums[c] = 0.0;
  }
  if (klists_shared) {
    for (long long j = tid; j < (long long)G * ks; j += T) {
      const long long g = j / ks, q = j % ks;
      if (q < maxm) {
        kbase[j] = __ldcg(a.ord_key + g * C + q);
        cbase[j] = __ldcg(a.ord_cl + g * C + q);
      }
    }
  }
  __syncthreads();
  for (long long k = 0; k < trips; ++k) {
    uint32_t p[4];
    load_keys4(a.keys, 4 * (gtid + k * gthreads), a.n, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t g = p[j] >> W;
      if (g >= (uint32_t)G) continue;
      const uint32_t u = p[j] & umask;
      const uint32_t* K = kbase + (size_t)g * ks;
      const uint32_t m = run_n[g];
      uint32_t lo = 0, hi = m;  // the first selected key >= u
      while (lo < hi) {
        const uint32_t mid = (lo + hi) >> 1;
        if (K[mid] < u) lo = mid + 1; else hi = mid;
      }
      if (lo < m && K[lo] == u) continue;  // a tie, added in (d)
      const long long cell = (long long)g * C + cbase[(size_t)g * ks + lo - 1];
      const double x = (double)from_order_key(u << a.bits_g);
      if (a.shared_sums) atomicAdd(sh_sums + cell, x);
      else atomicAdd(a.sums + GC + cell, x);
    }
  }
  if (a.shared_sums) {
    __syncthreads();
    for (long long c = tid; c < GC; c += T) {
      __stcg(a.partials + (size_t)blockIdx.x * GC + c, sh_sums[c]);
    }
    grid_sync(a.bar);
    stamp(a, 10);
    // A warp a cell: each lane adds every 32nd CTA's partial in CTA order,
    // then a fixed shuffle tree; the ties' sums from (d) first.
    for (long long c = warp; c < GC; c += gwarps) {
      double s = 0.0;
      for (int b = lane; b < (int)gridDim.x; b += 32) {
        s = __dadd_rn(s, __ldcg(a.partials + (size_t)b * GC + c));
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) s = __dadd_rn(s, __shfl_xor_sync(0xFFFFFFFFu, s, d));
      if (lane == 0) a.sums[GC + c] = __dadd_rn(__ldcg(a.sums + GC + c), s);
    }
  }
  if (a.stamps != nullptr) {
    grid_sync(a.bar);
    stamp(a, 11);
    if (blockIdx.x == 0 && tid == 0) {
      long long s1 = 0, s2 = 0;
      for (int g = 0; g < G; ++g) {
        s1 += __ldcg(a.slot1_n + (size_t)g * kLine);
        s2 += __ldcg(a.slot2_n + (size_t)g * kLine);
      }
      a.stamps[14] = s1;
      a.stamps[15] = s2;
    }
  }
}

// The scratch words (u32) px_tdigest_update carves for n rows, G groups, C
// clusters, the level bits and grid CTAs (ops/kernels/__init__.py
// tdigest_update_scratch_words computes the same): each array on a 16-byte
// boundary.
long long up4(long long w) { return (w + 3) & ~3ll; }

long long scratch_words(long long n, int G, int C, int b1, int b2, int b3, int grid,
                        int shared_sums) {
  const long long L1 = (long long)G << b1, R = up4((long long)G * C);
  const long long S1 = (long long)G * (((long long)1 << b1) < C ? ((long long)1 << b1) : C);
  long long w = up4(shared_sums ? 2 * (long long)grid * G * C : 0);  // partials (doubles)
  w += up4(n) + 2 * L1 + up4(G) + 4 + 3 * (long long)G * kLine + 9 * R;
  return w + 2 * (S1 << b2) + up4((S1 << b2) / 32) + (R << b3);
}

}  // namespace

extern "C" {

// values: f32 or f64 [n] (f64 = 1); gids int32 [n]; mask bool [n] or null;
// sums: f64 [2, G, C], written whole; scratch: scratch_len u32 words (at
// least scratch_words); bar: two u32, zero before the first launch on a
// stream (left so); stamps: null, or int64 [16] for the phases' end
// times. grid CTAs of kTuThreads, cooperative: fails if they cannot all be
// resident. smem: the dynamic shared bytes, region_words of them before the
// starts, counts and scans (3 G + 67 words).
int px_tdigest_update(const void* values, int f64, long long n, const void* gids,
                      const void* mask, int G, int C, int bits_g, int b1, int b2, int b3,
                      int shared_sums, int region_words, int smem, int grid, void* sums,
                      void* scratch, long long scratch_len, void* bar, void* stamps,
                      void* stream) {
  if (G < 1 || G > 254 || C < 1 || bits_g < 1 || bits_g > 8 || grid < 1 || n < 0 ||
      n >= (1ll << 31) || b1 < 1 || b2 != 8 || b3 < 8 || b3 > 9 || b1 + b2 + b3 != 32 - bits_g ||
      (long long)region_words < (((long long)G) << b1) || (long long)region_words < 10ll * C) {
    return (int)cudaErrorInvalidValue;
  }
  if (scratch_len < scratch_words(n, G, C, b1, b2, b3, grid, shared_sums)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = px::allow_smem(tdigest_update_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tdigest_update_kernel,
                                                      kTuThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (grid > per_sm * px::num_sms()) return (int)cudaErrorCooperativeLaunchTooLarge;
  TuArgs a = {};
  a.values = values;
  a.f64 = f64;
  a.gids = (const int*)gids;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.G = G;
  a.C = C;
  a.bits_g = bits_g;
  a.W = 32 - bits_g;
  a.b1 = b1;
  a.b2 = b2;
  a.b3 = b3;
  a.spg1 = (1 << b1) < C ? (1 << b1) : C;
  a.vec = (uintptr_t)values % 16 == 0 && (uintptr_t)gids % 16 == 0 &&
          (mask == nullptr || (uintptr_t)mask % 4 == 0);
  a.shared_sums = shared_sums;
  a.region_words = region_words;
  const long long L1 = (long long)G << b1, R = up4((long long)G * C);
  const long long S1 = (long long)G * a.spg1;
  uint32_t* w = (uint32_t*)scratch;
  a.partials = (double*)w;
  w += up4(shared_sums ? 2 * (long long)grid * G * C : 0);
  a.keys = w; w += up4(n);
  a.cum1 = w; w += L1;
  a.map1 = w; w += L1;
  a.gcount = w; w += up4(G);
  a.ctr = w; w += 4;
  a.slot1_n = w; w += (long long)G * kLine;
  a.slot2_n = w; w += (long long)G * kLine;
  a.run_n = w; w += (long long)G * kLine;
  a.run_rank = w; w += R;
  a.run_cnt = w; w += R;
  a.run_b = w; w += R;
  a.run_t = w; w += R;
  a.run_key = w; w += R;
  a.run_lt = w; w += R;
  a.run_eq = w; w += R;
  a.ord_key = w; w += R;
  a.ord_cl = w; w += R;
  a.hist2 = w; w += S1 << b2;
  a.map2 = w; w += S1 << b2;
  a.bits2 = w; w += up4((S1 << b2) / 32);
  a.hist3 = w;
  a.sums = (double*)sums;
  a.bar = (unsigned int*)bar;
  a.stamps = (long long*)stamps;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)tdigest_update_kernel, dim3(grid),
                                    dim3(kTuThreads), params, (size_t)smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
