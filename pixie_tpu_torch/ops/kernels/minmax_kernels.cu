// Segment min/max of the port's group-by (H11), built for Hopper (sm_90a)
// with the other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it).
//
// H11 px_segment_minmax  replaces pixie_tpu/ops/segment.py seg_min / seg_max
//    (:642, :657) and, through seg_max over the widened codes, seg_any and
//    the any() UDA's device lane (:670); the reference's sort-compact lane of
//    the same results (sorted_segment_minmax_compact, :411) is what the tests
//    hold against it under PERF.md's Fault-5 contract.
//
// Operation: state[g] = pick(state[g], values[i]) for every valid row i
// (mask true, 0 <= gid < S), IN PLACE, where pick is min or max. That equals
// the reference's pick(state, seg_fn(values, gids, S, mask)).
//
// Rows are read where the fold staged them (rows.cuh): uint8, uint16, int32
// or int64 with a frame-of-reference offset, or f64, 8 rows a thread, as
// 16-byte vectors with the streaming hint. An integer row's value is its
// widened bytes plus the offset, formed in registers (a 64-bit wrapping add,
// as segment.widen's) before any comparison, so the result equals the plain
// version's over the widened column for every offset. A column the fold
// narrowed (staging._narrow_int) stores value - min, non-negative and
// within its type, so value + offset never wraps there and the staged
// order is the int64 order.
//
// Order. int64 compares as itself. f64 compares by an order-preserving
// signed 64-bit key of its bits: a non-negative bit pattern is its own key,
// a negative one (sign bit set) has its other 63 bits flipped, so -0.0
// (key -1) sorts just below +0.0 (key 0), as XLA's scatter lane and
// jnp.minimum/maximum order them. Every NaN maps to the key that wins
// (LLONG_MAX under max, LLONG_MIN under min), which no other value reaches,
// so NaN propagates as the scatter lane's does; a NaN that wins is written
// back as the one canonical quiet NaN 0x7FF8000000000000, and a NaN already
// in the state stays as it is.
//
// Lanes (ops/kernels/__init__.py h11_lane chooses; the bounds measured on
// the H100, PERF.md §6):
// (a) S <= 8: one wave of CTAs; with S = 1 each thread keeps its running
//     key in a register, else in a private shared cell a group ([group]
//     [thread], no atomics); then warps reduce by shuffles, and a CTA
//     updates each group's global state once.
// (b) while S keys fit a block's opt-in shared memory: one wave of thread
//     block clusters of 8 CTAs. Each CTA folds its rows into its own S keys
//     by native shared atomics (the key read first, so a row that cannot
//     win makes none): 32-bit keys, the staged values, for a uint8,
//     uint16 or int32 row whose offset cannot wrap (the offset added at the
//     flush), else 64-bit ones. Then each rank picks its slice of the groups
//     over the cluster's 8 partials through distributed shared memory and
//     updates the global state once a group and cluster, not once a CTA.
// (c) otherwise: each row straight into the global state, every state read
//     made before any atomic, an atomic only where the row wins.
// int64 uses native atomicMin / atomicMax on long long. f64 has no atomic
// min or max and its state stays f64 in memory, so its global update is a
// compare-and-swap loop on the bits that stops as soon as the state wins.
//
// What bounds it on an H100: it reads each row once (1-8 bytes of value, 4
// of gid, 1 of mask) and reads and writes S x 8 bytes, so it is bytes-bound
// while the updates keep up. The staged rows cut the bytes of a narrowed
// column (flows' byte counts: 9 bytes a row, not 13), and their 32-bit keys
// the cost of the shared updates; every lane runs one wave with a chunk of
// 8 rows or so a thread, so every row's load is in flight at once; lane
// (a) has no atomics in its loop; lane (b) divides the flush of S keys by
// the cluster's 8. What is left over the bytes is the launch, one memory
// round trip and the shared updates.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <mutex>
#include <type_traits>
#include <vector>

#include "common.cuh"
#include "rows.cuh"

namespace {

constexpr long long kMaxKey = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kMinKey = -kMaxKey - 1;
constexpr long long kCanonicalNaN = 0x7FF8000000000000LL;

// The order key of an f64 (see the header); NaN takes the winning key.
template <bool IS_MIN>
__device__ __forceinline__ long long f64_key(double v) {
  if (v != v) return IS_MIN ? kMinKey : kMaxKey;
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ kMaxKey);
}

// The bits of the f64 whose key is k; the NaN key gives the canonical NaN.
template <bool IS_MIN>
__device__ __forceinline__ long long f64_bits(long long k) {
  if (k == (IS_MIN ? kMinKey : kMaxKey)) return kCanonicalNaN;
  return k >= 0 ? k : (k ^ kMaxKey);
}

template <bool IS_MIN, typename T>
__device__ __forceinline__ bool wins(T a, T b) {
  return IS_MIN ? a < b : a > b;
}

template <bool IS_MIN, typename T>
__device__ __forceinline__ T pick(T a, T b) {
  return wins<IS_MIN>(b, a) ? b : a;
}

// The key no row's key beats: what an untouched partial holds.
template <bool IS_MIN>
__device__ __forceinline__ long long empty_key() {
  return IS_MIN ? kMaxKey : kMinKey;
}

template <bool IS_MIN>
__device__ __forceinline__ void update_i64(long long* cell, long long v) {
  // Cells only move one way, so a stale read can only cost an extra atomic.
  if (!wins<IS_MIN>(v, *(volatile long long*)cell)) return;
  if (IS_MIN) {
    atomicMin(cell, v);
  } else {
    atomicMax(cell, v);
  }
}

template <bool IS_MIN>
__device__ __forceinline__ void update_f64(long long* cell, long long key) {
  unsigned long long* addr = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long old = *(volatile unsigned long long*)addr;
  while (true) {
    const double o = __longlong_as_double((long long)old);
    if (o != o) return;  // a NaN in the state stays
    if (!wins<IS_MIN>(key, f64_key<IS_MIN>(o))) return;
    const unsigned long long nw = (unsigned long long)f64_bits<IS_MIN>(key);
    const unsigned long long prev = atomicCAS(addr, old, nw);
    if (prev == old) return;
    old = prev;
  }
}

// The rows of one launch: the value column as staged (rows.cuh kind, the
// offset added to an integer row), gids, mask, and the state [S] (int64
// values, or f64 bits when kind is kF64).
struct MinmaxArgs {
  const void* vals;
  long long off;
  int kind;
  int vec_vals;  // the value column takes vector loads
  int vec;       // gids and mask take vector loads
  const int* gids;
  const unsigned char* mask;
  long long n;
  int S;
  long long* state;
};

// g[j] (-1 for an invalid row) and the order key k[j] of row i0 + j.
template <bool IS_MIN>
__device__ __forceinline__ void keys8(const MinmaxArgs& a, long long i0,
                                      int (&g)[px::kRowsPerThread],
                                      long long (&k)[px::kRowsPerThread]) {
  unsigned long long v[px::kRowsPerThread];
  px::load_gids8(a.gids, a.mask, i0, a.n, a.S, a.vec != 0, g);
  px::load_vals8(a.vals, a.kind, i0, a.n, a.vec_vals != 0, v);
  if (a.kind == px::kF64) {
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      k[j] = f64_key<IS_MIN>(__longlong_as_double((long long)v[j]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      k[j] = (long long)(v[j] + (unsigned long long)a.off);
    }
  }
}

// Updates group g's global state with a partial's key; an untouched
// partial (the empty key, which never changes a state) writes nothing.
template <bool IS_MIN>
__device__ __forceinline__ void flush_key(const MinmaxArgs& a, int g, long long key) {
  if (key == empty_key<IS_MIN>()) return;
  if (a.kind == px::kF64) {
    update_f64<IS_MIN>(a.state + g, key);
  } else {
    update_i64<IS_MIN>(a.state + g, key);
  }
}

// A 64-bit warp shuffle as two 32-bit ones.
__device__ __forceinline__ long long shfl_xor(long long v, int w) {
  const unsigned int lo = __shfl_xor_sync(0xFFFFFFFFu, (unsigned int)v, w);
  const unsigned int hi =
      __shfl_xor_sync(0xFFFFFFFFu, (unsigned int)((unsigned long long)v >> 32), w);
  return (long long)(((unsigned long long)hi << 32) | lo);
}

template <bool IS_MIN>
__device__ __forceinline__ long long warp_pick(long long v) {
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) v = pick<IS_MIN>(v, shfl_xor(v, w));
  return v;
}

// ---------------------------------------------------------------- (a)
constexpr int kRegsThreads = 256;
constexpr int kRegsMaxCtasPerSm = 8;  // 2048 threads: an SM's most
constexpr size_t kSmemPerSm = 200 * 1024;  // of an SM's 228 KB, room left for the rest

template <int SB, bool IS_MIN>
__global__ void __launch_bounds__(kRegsThreads) minmax_regs_kernel(const MinmaxArgs a) {
  extern __shared__ long long sh_cells[];  // [SB][threads] when SB > 1
  __shared__ long long sh_warp[kRegsThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t / 32;
  const long long empty = empty_key<IS_MIN>();
  long long acc = empty;  // SB == 1: the thread's running key
  if (SB > 1) {
#pragma unroll
    for (int s = 0; s < SB; ++s) sh_cells[s * kRegsThreads + t] = empty;
  }
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + t; c < chunks; c += stride) {
    int g[px::kRowsPerThread];
    long long k[px::kRowsPerThread];
    keys8<IS_MIN>(a, c * px::kRowsPerThread, g, k);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (g[j] < 0) continue;
      if (SB == 1) {
        acc = pick<IS_MIN>(acc, k[j]);
      } else {
        long long* cell = &sh_cells[g[j] * kRegsThreads + t];
        if (wins<IS_MIN>(k[j], *cell)) *cell = k[j];
      }
    }
  }
  if (SB == 1) {
    acc = warp_pick<IS_MIN>(acc);
    if (lane == 0) sh_warp[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      long long v = lane < kRegsThreads / 32 ? sh_warp[lane] : empty;
      v = warp_pick<IS_MIN>(v);
      if (lane == 0) flush_key<IS_MIN>(a, 0, v);
    }
    return;
  }
  __syncthreads();
  // Group x of the CTA by one warp: its threads' cells, then a shuffle.
  for (int x = warp; x < SB && x < a.S; x += kRegsThreads / 32) {
    long long v = empty;
    for (int q = lane; q < kRegsThreads; q += 32) {
      v = pick<IS_MIN>(v, sh_cells[x * kRegsThreads + q]);
    }
    v = warp_pick<IS_MIN>(v);
    if (lane == 0) flush_key<IS_MIN>(a, x, v);
  }
}

// ---------------------------------------------------------------- (b)
constexpr int kCluster = 8;  // CTAs of a cluster (ops/kernels/__init__.py H11_CLUSTER)

// NARROW (a uint8, uint16 or int32 row whose offset cannot wrap over its
// type's range, px_segment_minmax decides): the CTA's keys are the staged
// 32-bit values, native 32-bit shared atomics, and the offset is added at
// the flush; a row equal to the empty key marks its group touched instead.
template <bool IS_MIN, bool NARROW>
__global__ void __launch_bounds__(px::kThreads) minmax_cluster_kernel(const MinmaxArgs a) {
  namespace cg = cooperative_groups;
  using K = typename std::conditional<NARROW, int, long long>::type;
  extern __shared__ long long sh_raw[];
  K* sh_keys = reinterpret_cast<K*>(sh_raw);                                    // [S]
  unsigned char* sh_touched = reinterpret_cast<unsigned char*>(sh_keys + a.S);  // [S]
  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.S;
  const K empty = NARROW ? (K)(IS_MIN ? INT_MAX : INT_MIN) : (K)empty_key<IS_MIN>();
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    sh_keys[c] = empty;
    if (NARROW) sh_touched[c] = 0;
  }
  __syncthreads();
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    int g[px::kRowsPerThread];
    long long k[px::kRowsPerThread];
    keys8<IS_MIN>(a, c * px::kRowsPerThread, g, k);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (g[j] < 0) continue;
      const K kk = NARROW ? (K)(k[j] - a.off) : (K)k[j];
      if (NARROW && kk == empty) {
        sh_touched[g[j]] = 1;
        continue;
      }
      if (!wins<IS_MIN>(kk, sh_keys[g[j]])) continue;
      if (IS_MIN) {
        atomicMin(&sh_keys[g[j]], kk);
      } else {
        atomicMax(&sh_keys[g[j]], kk);
      }
    }
  }
  cluster.sync();  // every CTA's partial is complete
  const int slice = (S + kCluster - 1) / kCluster;
  const int lo = (int)cluster.block_rank() * slice;
  const int hi = min(S, lo + slice);
  for (int g = lo + threadIdx.x; g < hi; g += blockDim.x) {
    K v = empty;
    bool touched = false;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      v = pick<IS_MIN>(v, *cluster.map_shared_rank(&sh_keys[g], q));
      if (NARROW) touched |= *cluster.map_shared_rank(&sh_touched[g], q) != 0;
    }
    if (!NARROW) {
      flush_key<IS_MIN>(a, g, (long long)v);
    } else if (v != empty || touched) {
      flush_key<IS_MIN>(a, g, (long long)v + a.off);
    }
  }
  cluster.sync();  // no CTA leaves while others read its partial
}

// ---------------------------------------------------------------- (c)
template <bool IS_MIN>
__global__ void __launch_bounds__(px::kThreads) minmax_global_kernel(const MinmaxArgs a) {
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool f64 = a.kind == px::kF64;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    int g[px::kRowsPerThread];
    long long k[px::kRowsPerThread], cur[px::kRowsPerThread];
    keys8<IS_MIN>(a, c * px::kRowsPerThread, g, k);
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (g[j] < 0) {
        cur[j] = k[j];  // never wins against itself
        continue;
      }
      // A NaN state (f64) takes the winning key: no row beats it.
      const long long s = __ldcg(a.state + g[j]);
      cur[j] = f64 ? f64_key<IS_MIN>(__longlong_as_double(s)) : s;
    }
#pragma unroll
    for (int j = 0; j < px::kRowsPerThread; ++j) {
      if (!wins<IS_MIN>(k[j], cur[j])) continue;
      if (f64) {
        update_f64<IS_MIN>(a.state + g[j], k[j]);
      } else {
        update_i64<IS_MIN>(a.state + g[j], k[j]);
      }
    }
  }
}

// ---------------------------------------------------------------- launch
template <int SB, bool IS_MIN>
cudaError_t launch_regs(const MinmaxArgs& a, long long chunks, cudaStream_t st) {
  const size_t smem = SB > 1 ? (size_t)SB * kRegsThreads * sizeof(long long) : 0;
  cudaError_t err = cudaFuncSetAttribute(minmax_regs_kernel<SB, IS_MIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // One wave of as many CTAs as the private cells let an SM hold: a chunk
  // or so a thread, every row's load in flight at once.
  const long long per_sm = smem == 0 ? kRegsMaxCtasPerSm
                                     : std::min<long long>(kRegsMaxCtasPerSm, kSmemPerSm / smem);
  long long grid = (long long)px::num_sms() * per_sm;
  const long long want = (chunks + kRegsThreads - 1) / kRegsThreads;
  if (want < grid) grid = want > 0 ? want : 1;
  minmax_regs_kernel<SB, IS_MIN><<<(int)grid, kRegsThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool IS_MIN>
cudaError_t launch_regs_bucket(const MinmaxArgs& a, int bucket, long long chunks,
                               cudaStream_t st) {
  switch (bucket) {
    case 1: return launch_regs<1, IS_MIN>(a, chunks, st);
    case 8: return launch_regs<8, IS_MIN>(a, chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

// Clusters of a minmax_cluster_kernel instance that fit the card at once
// at a shared size, by device, found once: the attribute calls and the
// occupancy query cost the host more than a small launch.
struct ClusterFit {
  int device;
  const void* kernel;
  size_t smem;
  int clusters;
};
std::mutex g_fit_lock;
std::vector<ClusterFit> g_fits;

// The cluster lane's launch: one wave of as many clusters as fit the card
// (a chunk or so a thread), no more CTAs than the rows need.
template <bool IS_MIN, bool NARROW>
cudaError_t launch_cluster(const MinmaxArgs& a, long long chunks, cudaStream_t st) {
  const auto kernel = minmax_cluster_kernel<IS_MIN, NARROW>;
  const size_t smem = (size_t)a.S * (NARROW ? sizeof(int) + 1 : sizeof(long long));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  {
    std::lock_guard<std::mutex> hold(g_fit_lock);
    for (const ClusterFit& f : g_fits) {
      if (f.device == dev && f.kernel == (const void*)kernel && f.smem == smem) {
        clusters = f.clusters;
      }
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(px::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    std::lock_guard<std::mutex> hold(g_fit_lock);
    g_fits.push_back({dev, (const void*)kernel, smem, clusters});
  }
  long long ctas = (long long)clusters * kCluster;
  const long long want = (chunks + px::kThreads - 1) / px::kThreads;
  const long long need = (want + kCluster - 1) / kCluster * kCluster;
  if (need < ctas) ctas = need > kCluster ? need : kCluster;
  cfg.gridDim = dim3((unsigned)ctas);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether a row's staged value orders as its value plus the offset in 32
// bits: a uint8, uint16 or int32 row whose offset cannot wrap over the
// type's range (a column the fold narrowed never does).
bool narrow32(const MinmaxArgs& a) {
  long long lo = 0, hi = 0;
  switch (a.kind) {
    case px::kU8: hi = 255; break;
    case px::kU16: hi = 65535; break;
    case px::kI32: lo = INT_MIN; hi = INT_MAX; break;
    default: return false;
  }
  return a.off <= LLONG_MAX - hi && a.off >= LLONG_MIN - lo;
}

template <bool IS_MIN>
cudaError_t launch_minmax(const MinmaxArgs& a, int lane, int arg, cudaStream_t st) {
  const long long chunks = (a.n + px::kRowsPerThread - 1) / px::kRowsPerThread;
  if (lane == 0) {
    if (a.S > arg) return cudaErrorInvalidValue;
    return launch_regs_bucket<IS_MIN>(a, arg, chunks, st);
  }
  if (lane == 1) {
    return narrow32(a) ? launch_cluster<IS_MIN, true>(a, chunks, st)
                       : launch_cluster<IS_MIN, false>(a, chunks, st);
  }
  minmax_global_kernel<IS_MIN><<<px::grid_for(chunks, 8), px::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// H11. vals: [n] of ``kind`` (rows.cuh: kU8, kU16, kI32, kI64 with the
// offset ``off`` added, or kF64); state: int64 or f64 [S] (f64 exactly when
// kind is kF64), updated in place. lane 0: the register lane, ``arg`` its
// bucket (1 or 8 groups, at least S); 1: clusters of 8 CTAs holding S keys
// each; 2: global atomics (ops/kernels/__init__.py h11_lane chooses).
int px_segment_minmax(const void* vals, int kind, long long off, long long n, const void* gids,
                      const void* mask, int S, void* state, int is_min, int lane, int arg,
                      void* stream) {
  if (S <= 0 || (kind != px::kU8 && kind != px::kU16 && kind != px::kI32 &&
                 kind != px::kI64 && kind != px::kF64)) {
    return (int)cudaErrorInvalidValue;
  }
  MinmaxArgs a;
  a.vals = vals;
  a.off = kind == px::kF64 ? 0 : off;
  a.kind = kind;
  a.vec_vals = px::vec_aligned(vals, kind);
  a.vec = px::vec_aligned(gids, px::kI32) && (mask == nullptr || (uintptr_t)mask % 8 == 0);
  a.gids = (const int*)gids;
  a.mask = (const unsigned char*)mask;
  a.n = n;
  a.S = S;
  a.state = (long long*)state;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_min ? launch_minmax<true>(a, lane, arg, st)
                      : launch_minmax<false>(a, lane, arg, st));
}

}  // extern "C"
