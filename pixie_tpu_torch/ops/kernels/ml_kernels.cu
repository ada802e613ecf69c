// The ML lane's kernels (reservoir sampling and k-means), built for Hopper
// (sm_90a) with the other kernel sources into one shared library that has a
// plain C interface (ops/kernels/__init__.py builds and binds it). Each
// launches on the CUDA runtime's current device and the caller's stream,
// allocates nothing, and returns the cudaError_t of its launch.
//
// H25 px_reservoir_priority replaces pixie_tpu/ops/ml.py _priorities (:37)
//    with K9's 64-bit path (pixie_tpu/ops/hashing.py:22,30,40): row i of a
//    block gets combine(hash64(word_i), hash64(i + salt)) >> 11, as f64 /
//    2^53; a masked row gets -inf. salt is a device scalar (the state's
//    count sum), so the fold never waits for it. One thread a row,
//    grid-stride. Bound: bytes, 17 B a row (the word, the mask, the f64).
// H26 px_reservoir_topk  replaces ml.py reservoir_update (:47),
//    topk_by_priority (:80) and reservoir_merge (:94): per group, the k
//    highest priorities of the state's k slots and the group's candidate
//    rows, in descending order; ties keep the reference's stable order (the
//    state's slots first, then the rows in row order). The caller buckets
//    the rows by group (a stable sort of the gids: order, offsets). A
//    priority is the 53-bit integer key = p * 2^53 (-inf: -1), which
//    orders them exactly; an entry's origin (slot s, or k + its bucketed
//    position) breaks ties. Bound: bytes (each row's order index and
//    priority, the entering rows' values, the state).
//    The first design ran one CTA a group over all its rows and bitonic-
//    sorted a fixed 1024-entry buffer at every cut: at the main path's 16
//    groups 16 CTAs walked ~92k rows each on an idle card (0.270 ms, 38x
//    its bound), at 4096 groups each CTA sorted 1024 entries for ~360 rows
//    (0.242 ms), and the caller's stable sort of the gids cost more than
//    the kernel. Now there are two entries. px_reservoir_topk_rows (up to
//    64 groups, G k <= 1024: the main path's 16 services) fills the card
//    and needs no sort: a CTA a chunk of the rows in row order keeps every
//    group's best k in one buffer (a cut sorts it by group and keeps k a
//    group), then merges of runs of those lists, then a CTA a group merges
//    the state and the lists and counts the group's rows.
//    px_reservoir_topk (bucketed rows: the merges, whose n = G k rows need
//    no more CTAs, and updates of many groups, which fill the card alone)
//    runs one CTA a group over the state and the group's rows.
//    Pruning stays exact across CTAs: an item at or below the k-th best of
//    entries with earlier origins (the state's, or the buffer's after a
//    cut, since items arrive in origin order) cannot enter; a chunk or a
//    merge of the sort-free entry also publishes its k-th best (atomicMax
//    on a per-group word the wrapper fills with -1 each call) and the
//    others prune strictly below it, since a row equal to it may still beat
//    that CTA's entries on origin. Each thread reads 4 rows' order indices or gids (coalesced)
//    before their priorities; a cut orders the entries present, by rank
//    counting up to 256 entries and by a bitonic sort of the next power of
//    two above that, never a fixed 1024. Buffer 2048 entries: k <= 1024.
// H27 px_kmeans_fit      replaces ml.py kmeans_fit (:128, vmapped over
//    groups): one CTA a group, its S x d f32 points and weights in shared
//    memory. Farthest-point seeding from the first live point, min(k, S) -
//    1 steps (dead points -inf), then iters Lloyd steps; distances as
//    sum (p - c)^2; an empty cluster keeps its center. NaN as the
//    reference takes it: a point's minimum distance is NaN when one is
//    (jnp.min), seeding's argmax and Lloyd's argmin take the first NaN,
//    else the first maximum or minimum, and a (center, coordinate) sum is
//    NaN when any point's (one-hot x weight) x coordinate is (onehot.T @
//    points: 0 x inf and 0 x NaN are NaN). The first design kept
//    the points as [S][64] in shared memory, so a warp's 32 points read one
//    bank (32-way conflicts), recomputed every chosen center at each
//    seeding step, took the argmax and the first live point on thread 0,
//    summed every (center, coordinate) over all S points, and dropped NaN
//    (fminf, > and <): 0.551 ms at G 16, S 128, d 64, k 8 (PERF.md). Now:
//    the points padded to a stride of 4 mod 8 floats (16-byte loads of 8
//    points hit 32 banks), a running minimum updated by the newest center
//    alone, the first live point by a warp reduction and the argmax by warp
//    shuffles on (value, index), four centers a pass over a point's
//    coordinates, and each cluster's members as bit masks (ballots), then
//    the points sorted by cluster from the masks' counts, so a center's
//    coordinate sums its members alone (a thread two coordinates), in
//    index order (no atomics: the same bits every run), with counts of the
//    non-finite terms to give the reference's NaN (counted only when a
//    CTA-wide vote finds one). One CTA a group: 16 groups fill 16 of 132
//    SMs; Lloyd's assign is bound by its SM's shared-memory reads of the
//    centers, which a warp broadcasts (PERF.md).
//    Bound: operations, a few hundred kFLOP a group.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "hash64.cuh"

namespace {

using px::grid_for;
using px::kThreads;

constexpr double kTwo53 = 9007199254740992.0;

__device__ __forceinline__ double neg_inf() { return __longlong_as_double(0xFFF0000000000000ll); }

// ---------------------------------------------------------------- H25
__global__ void reservoir_priority_kernel(const unsigned long long* __restrict__ words,
                                          long long n, const unsigned char* __restrict__ mask,
                                          const long long* __restrict__ salt,
                                          double* __restrict__ out) {
  const unsigned long long s = (unsigned long long)salt[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && !mask[i]) {
      out[i] = neg_inf();
      continue;
    }
    const unsigned long long h =
        px::combine64(px::hash64(words[i]), px::hash64((unsigned long long)i + s));
    out[i] = (double)(h >> 11) / kTwo53;
  }
}

// ---------------------------------------------------------------- H26
constexpr int kTopkThreads = 256;
constexpr int kTopkPer = 4;                         // items a thread takes a step
constexpr int kTopkStep = kTopkThreads * kTopkPer;  // items a step
constexpr int kTopkCap = 2 * kTopkStep;             // buffer entries
constexpr int kTopkMaxK = kTopkCap - kTopkStep;     // a cut's k entries and one step fit

// The exact integer key of a priority m / 2^53; -inf (an empty slot, a
// masked row) is -1.
__device__ __forceinline__ long long pri_key(double p) {
  return p >= 0.0 ? (long long)(p * kTwo53) : -1ll;
}

// Whether entry (ka, oa) comes before (kb, ob): higher key, then lower origin.
__device__ __forceinline__ bool before(long long ka, int oa, long long kb, int ob) {
  return ka > kb || (ka == kb && oa < ob);
}

// A CTA's candidate buffer. ``thr``: an item at or below it cannot enter
// (k entries of earlier origin beat it: the state's k-th best, or the
// buffer's after a cut).
struct TopkBuf {
  long long key[kTopkCap];
  int org[kTopkCap];
  int n;
  long long thr;
};

// Lists of at most k entries (key desc, origin asc) in scratch: list s of
// group g is slot g * S + s; ``rows`` counts the candidate rows the list
// stands for.
struct TopkLists {
  long long* key;
  int* org;
  int* cnt;
  int* rows;
  int S;
};

// Whether (ga, ka, oa) comes before (gb, kb, ob): lower group, then ``before``.
__device__ __forceinline__ bool before_g(int ga, long long ka, int oa, int gb, long long kb,
                                         int ob) {
  return ga < gb || (ga == gb && before(ka, oa, kb, ob));
}

// Bitonic sort of key/org (and gid, when given)[0, p), p a power of two,
// into ``before`` (``before_g``) order.
__device__ void bitonic(long long* key, int* org, int* gid, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kTopkThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const long long ki = key[i], kj = key[j];
        const int oi = org[i], oj = org[j];
        const int gi = gid != nullptr ? gid[i] : 0, gj = gid != nullptr ? gid[j] : 0;
        const bool j_first = before_g(gj, kj, oj, gi, ki, oi);
        if ((i & size) == 0 ? j_first : !j_first) {
          key[i] = kj;
          key[j] = ki;
          org[i] = oj;
          org[j] = oi;
          if (gid != nullptr) {
            gid[i] = gj;
            gid[j] = gi;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Pads [n, p) with entries after every other and sorts [0, p), p the
// power of two above n (at least a thread's worth).
__device__ void pad_and_sort(TopkBuf& b, int* gid, int n) {
  int p = kTopkThreads;
  while (p < n) p <<= 1;
  for (int i = n + threadIdx.x; i < p; i += kTopkThreads) {
    b.key[i] = LLONG_MIN;
    b.org[i] = INT_MAX;
    if (gid != nullptr) gid[i] = INT_MAX;
  }
  __syncthreads();
  bitonic(b.key, b.org, gid, p);
}

// Puts the buffer's best min(n, k) entries at [0, kept) in ``before``
// order and returns kept. Up to a thread's worth of entries each thread
// counts the entries before its own (its rank; origins are unique); more
// are sorted.
__device__ int cut(TopkBuf& b, int k) {
  const int n = b.n;
  if (n <= kTopkThreads) {
    const int t = threadIdx.x;
    long long mk = 0;
    int mo = 0, rank = 0;
    if (t < n) {
      mk = b.key[t];
      mo = b.org[t];
      for (int j = 0; j < n; ++j) rank += before(b.key[j], b.org[j], mk, mo);
    }
    __syncthreads();
    if (t < n && rank < k) {
      b.key[rank] = mk;
      b.org[rank] = mo;
    }
  } else {
    pad_and_sort(b, nullptr, n);
  }
  __syncthreads();
  return min(n, k);
}

__device__ __forceinline__ void insert(TopkBuf& b, long long key, int org) {
  const int pos = atomicAdd(&b.n, 1);
  b.key[pos] = key;
  b.org[pos] = org;
}

// The end of a step: when the next step might not fit, cut to k and raise
// ``thr`` to the k-th best kept (every later item has a later origin).
__device__ void settle(TopkBuf& b, int k) {
  __syncthreads();
  const int n = b.n;
  __syncthreads();  // every thread has read n before the next step's inserts
  if (n > kTopkCap - kTopkStep) {
    const int kept = cut(b, k);
    if (threadIdx.x == 0) {
      b.n = kept;
      if (kept == k) b.thr = max(b.thr, b.key[k - 1]);
    }
    __syncthreads();
  }
}

// The least key of group g's k state slots (its k-th best: a state holds
// exactly k slots), reduced by the calling warp.
__device__ __forceinline__ long long state_min(const double* __restrict__ st_pri, long long g, int k) {
  long long m = LLONG_MAX;
  for (int i = threadIdx.x & 31; i < k; i += 32) m = min(m, pri_key(st_pri[g * k + i]));
  for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The state's k-th best key into ``thr``; with ``preload`` its slots also
// fill the buffer as origins 0..k-1, ahead of every row.
__device__ void load_state(TopkBuf& b, const double* __restrict__ st_pri, long long g, int k,
                           bool preload) {
  if (preload) {
    for (int i = threadIdx.x; i < k; i += kTopkThreads) {
      b.key[i] = pri_key(st_pri[g * k + i]);
      b.org[i] = i;
    }
  }
  if (threadIdx.x < 32) {
    const long long m = state_min(st_pri, g, k);
    if (threadIdx.x == 0) {
      b.thr = m;
      b.n = preload ? k : 0;
    }
  }
  __syncthreads();
}

// Feeds the bucketed rows [a, e) (origins k + position), kTopkPer a thread
// a step: each thread reads its rows' order indices (coalesced), then their
// priorities. A row enters above ``thr``.
__device__ void feed_rows(TopkBuf& b, long long a, long long e, int k,
                          const double* __restrict__ row_pri, const long long* __restrict__ order) {
  for (long long base = a; base < e; base += kTopkStep) {
    const long long thr = b.thr;
    long long idx[kTopkPer];
#pragma unroll
    for (int j = 0; j < kTopkPer; ++j) {
      const long long r = base + j * kTopkThreads + threadIdx.x;
      idx[j] = r < e ? __ldg(&order[r]) : -1ll;
    }
#pragma unroll
    for (int j = 0; j < kTopkPer; ++j) {
      if (idx[j] >= 0) {
        const long long kr = pri_key(__ldg(&row_pri[idx[j]]));
        if (kr > thr) insert(b, kr, k + (int)(base + j * kTopkThreads + threadIdx.x));
      }
    }
    settle(b, k);
  }
}

// Feeds group g's lists [s0, s1) of ``in``, whole lists a step, so that a
// cut between steps leaves only earlier origins.
__device__ void feed_lists(TopkBuf& b, const TopkLists& in, long long g, int s0, int s1, int k,
                           long long pub) {
  const int per = max(1, kTopkStep / k);
  for (int sa = s0; sa < s1; sa += per) {
    const long long thr = b.thr;
    const int items = (min(s1, sa + per) - sa) * k;
    for (int f = threadIdx.x; f < items; f += kTopkThreads) {
      const int q = f / k;
      const int i = f - q * k;
      const long long slot = g * in.S + sa + q;
      // The key is read with its list's count (past the count it is
      // scratch, read and ignored).
      const int cnt = in.cnt[slot];
      const long long kr = in.key[slot * k + i];
      if (i < cnt && kr > thr && kr >= pub) insert(b, kr, in.org[slot * k + i]);
    }
    settle(b, k);
  }
}

// The buffer's kept entries [0, kept) as list ``slot`` of ``out``.
__device__ void write_list(const TopkBuf& b, const TopkLists& out, long long slot, int k,
                           int kept, int rows) {
  for (int i = threadIdx.x; i < kept; i += kTopkThreads) {
    out.key[slot * k + i] = b.key[i];
    out.org[slot * k + i] = b.org[i];
  }
  if (threadIdx.x == 0) {
    out.cnt[slot] = kept;
    out.rows[slot] = rows;
  }
}

// The buffer's kept entries as group g's new state: values of the state's
// slots or of the rows (origin k + position p: row ``order[p]``, or row p
// without ``order``); an empty slot holds 0 and -inf, as every empty slot
// of the reference does.
__device__ void write_state(const TopkBuf& b, long long g, int k, int kept,
                            const long long* __restrict__ st_vals,
                            const long long* __restrict__ row_vals,
                            const long long* __restrict__ order, long long* __restrict__ out_vals,
                            double* __restrict__ out_pri) {
  for (int i = threadIdx.x; i < k; i += kTopkThreads) {
    long long v = 0;
    double p = neg_inf();
    if (i < kept && b.key[i] >= 0) {
      const int o = b.org[i];
      p = (double)b.key[i] / kTwo53;
      v = o < k ? st_vals[g * k + o] : row_vals[order != nullptr ? order[o - k] : o - k];
    }
    out_vals[g * k + i] = v;
    out_pri[g * k + i] = p;
  }
}

// The bucketed path: one CTA a group, the state and all its rows, to the
// new state.
__global__ void __launch_bounds__(kTopkThreads)
    topk_rows_kernel(const long long* __restrict__ st_vals, const double* __restrict__ st_pri,
                     int k, const long long* __restrict__ row_vals,
                     const double* __restrict__ row_pri, const long long* __restrict__ order,
                     const long long* __restrict__ offsets, long long* __restrict__ out_vals,
                     double* __restrict__ out_pri) {
  __shared__ TopkBuf b;
  const long long g = blockIdx.x;
  load_state(b, st_pri, g, k, true);
  feed_rows(b, offsets[g], offsets[g + 1], k, row_pri, order);
  const int kept = cut(b, k);
  write_state(b, g, k, kept, st_vals, row_vals, order, out_vals, out_pri);
}

// Merges lists. kFinal: one CTA a group, the state and the group's in.S
// lists, to the new state (and, with ``out_count``, the state's count plus
// the lists' rows). Else one CTA a (group, m) of in.S x out.S: lists
// [in.S m / out.S, in.S (m + 1) / out.S) to list m of ``out``, its k-th
// best to thr_pub[g].
template <bool kFinal>
__global__ void __launch_bounds__(kTopkThreads)
    topk_lists_kernel(const long long* __restrict__ st_vals, const double* __restrict__ st_pri,
                      const long long* __restrict__ st_count, int k,
                      const long long* __restrict__ row_vals, const long long* __restrict__ order,
                      TopkLists in, TopkLists out, long long* thr_pub,
                      long long* __restrict__ out_vals, double* __restrict__ out_pri,
                      long long* __restrict__ out_count) {
  __shared__ TopkBuf b;
  const long long g = kFinal ? blockIdx.x : blockIdx.x / out.S;
  const int m = kFinal ? 0 : (int)(blockIdx.x - g * out.S);
  const int s0 = kFinal ? 0 : (int)((long long)in.S * m / out.S);
  const int s1 = kFinal ? in.S : (int)((long long)in.S * (m + 1) / out.S);
  load_state(b, st_pri, g, k, kFinal);
  feed_lists(b, in, g, s0, s1, k, thr_pub[g]);
  const int kept = cut(b, k);
  int rows = 0;  // the lists' candidate rows, summed by warp 0 (thread 0 holds the total)
  if (threadIdx.x < 32) {
    for (int s = s0 + threadIdx.x; s < s1; s += 32) rows += in.rows[g * in.S + s];
    for (int o = 16; o > 0; o >>= 1) rows += __shfl_xor_sync(0xffffffffu, rows, o);
  }
  if (kFinal) {
    write_state(b, g, k, kept, st_vals, row_vals, order, out_vals, out_pri);
    if (threadIdx.x == 0 && out_count != nullptr) out_count[g] = st_count[g] + rows;
  } else {
    write_list(b, out, g * out.S + m, k, kept, rows);
    if (threadIdx.x == 0 && kept == k) atomicMax(&thr_pub[g], b.key[k - 1]);
  }
}

// The sort-free path for few groups (G <= kChunkMaxG, G k <= kTopkMaxK):
// one CTA a chunk of the rows in row order (origins k + row index) keeps
// every group's best k in one buffer. A cut sorts the buffer by (group,
// key desc, origin) and keeps the first k of each group; each group keeps
// its own ``thr`` and publishes its k-th best. Writes list c of each group
// (in.S = C) with the group's candidate rows in the chunk.
constexpr int kChunkMaxG = 64;
constexpr int kTopkSlots = kTopkCap / kTopkThreads;  // entries a thread holds in a cut

struct ChunkState {
  int gid[kTopkCap];
  long long thr[kChunkMaxG];
  long long pub[kChunkMaxG];
  int cnt[kChunkMaxG];
  int start[kChunkMaxG];
  int kstart[kChunkMaxG];
  int rows[kChunkMaxG];
};

// Cuts the buffer to each group's best k, groups in order, each group's
// entries from ``kstart``; raises and publishes each full group's k-th best.
__device__ void cut_groups(TopkBuf& b, ChunkState& cs, int G, int k, long long* thr_pub) {
  const int n = b.n;
  if (threadIdx.x == 0) {
    int s = 0, t = 0;
    for (int g = 0; g < G; ++g) {
      cs.start[g] = s;
      cs.kstart[g] = t;
      s += cs.cnt[g];
      t += min(cs.cnt[g], k);
    }
  }
  long long mk[kTopkSlots];
  int mo[kTopkSlots], mg[kTopkSlots], pos[kTopkSlots];
  if (n <= kTopkThreads) {
    const int t = threadIdx.x;
    pos[0] = -1;
    if (t < n) {
      mk[0] = b.key[t];
      mo[0] = b.org[t];
      mg[0] = cs.gid[t];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += before_g(cs.gid[j], b.key[j], b.org[j], mg[0], mk[0], mo[0]);
      pos[0] = rank;
    }
#pragma unroll
    for (int q = 1; q < kTopkSlots; ++q) pos[q] = -1;
  } else {
    pad_and_sort(b, cs.gid, n);
#pragma unroll
    for (int q = 0; q < kTopkSlots; ++q) {
      const int i = threadIdx.x + q * kTopkThreads;
      pos[q] = i < n ? i : -1;
      if (i < n) {
        mk[q] = b.key[i];
        mo[q] = b.org[i];
        mg[q] = cs.gid[i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kTopkSlots; ++q) {
    if (pos[q] < 0) continue;
    const int gr = pos[q] - cs.start[mg[q]];
    if (gr < k) {
      const int at = cs.kstart[mg[q]] + gr;
      b.key[at] = mk[q];
      b.org[at] = mo[q];
      cs.gid[at] = mg[q];
      if (gr == k - 1) {
        cs.thr[mg[q]] = max(cs.thr[mg[q]], mk[q]);
        atomicMax(&thr_pub[mg[q]], mk[q]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int kept = 0;
    for (int g = 0; g < G; ++g) {
      cs.cnt[g] = min(cs.cnt[g], k);
      kept += cs.cnt[g];
    }
    b.n = kept;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTopkThreads)
    topk_chunk_kernel(const double* __restrict__ st_pri, int G, int k,
                      const double* __restrict__ row_pri, const int* __restrict__ gids,
                      long long n, TopkLists lists, long long* thr_pub) {
  __shared__ TopkBuf b;
  __shared__ ChunkState cs;
  const int C = lists.S;
  const int c = blockIdx.x;
  const long long lo = n * c / C, hi = n * (c + 1) / C;
  for (int g = threadIdx.x; g < G; g += kTopkThreads) {
    cs.cnt[g] = 0;
    cs.rows[g] = 0;
  }
  if (threadIdx.x == 0) b.n = 0;
  for (int g = threadIdx.x >> 5; g < G; g += kTopkThreads / 32) {  // a warp a group
    const long long m = state_min(st_pri, g, k);
    if ((threadIdx.x & 31) == 0) cs.thr[g] = m;
  }
  for (int g = threadIdx.x; g < G; g += kTopkThreads) cs.pub[g] = *(volatile long long*)&thr_pub[g];
  __syncthreads();
  for (long long base = lo; base < hi; base += kTopkStep) {
    int gi[kTopkPer];
    double pr[kTopkPer];
#pragma unroll
    for (int j = 0; j < kTopkPer; ++j) {
      const long long r = base + j * kTopkThreads + threadIdx.x;
      gi[j] = r < hi ? __ldg(&gids[r]) : G;
      pr[j] = r < hi ? __ldg(&row_pri[r]) : -1.0;
    }
#pragma unroll
    for (int j = 0; j < kTopkPer; ++j) {
      if ((unsigned)gi[j] < (unsigned)G) {
        atomicAdd(&cs.rows[gi[j]], 1);  // the chunk's candidate rows a group
        const long long kr = pri_key(pr[j]);
        if (kr > cs.thr[gi[j]] && kr >= cs.pub[gi[j]]) {
          const int p = atomicAdd(&b.n, 1);
          b.key[p] = kr;
          b.org[p] = k + (int)(base + j * kTopkThreads + threadIdx.x);
          cs.gid[p] = gi[j];
          atomicAdd(&cs.cnt[gi[j]], 1);
        }
      }
    }
    __syncthreads();
    const int held = b.n;
    // The next step's published thresholds: nothing reads cs.pub until the
    // barrier below.
    for (int g = threadIdx.x; g < G; g += kTopkThreads) cs.pub[g] = *(volatile long long*)&thr_pub[g];
    __syncthreads();
    if (held > kTopkCap - kTopkStep) cut_groups(b, cs, G, k, thr_pub);
  }
  __syncthreads();
  cut_groups(b, cs, G, k, thr_pub);
  for (int i = threadIdx.x; i < b.n; i += kTopkThreads) {
    const int g = cs.gid[i];
    const long long slot = (long long)g * C + c;
    lists.key[slot * k + i - cs.kstart[g]] = b.key[i];
    lists.org[slot * k + i - cs.kstart[g]] = b.org[i];
  }
  for (int g = threadIdx.x; g < G; g += kTopkThreads) {
    lists.cnt[(long long)g * C + c] = cs.cnt[g];
    lists.rows[(long long)g * C + c] = cs.rows[g];
  }
}

// ---------------------------------------------------------------- H27
constexpr int kKmThreads = 256;
constexpr int kKmWarps = kKmThreads / 32;

__device__ __forceinline__ bool km_finite(float x) {
  return (__float_as_uint(x) & 0x7F800000u) != 0x7F800000u;
}

// jnp.min's and torch.amin's minimum: a NaN wins.
__device__ __forceinline__ float km_nanmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// Whether (av, ai) comes before (bv, bi) in jnp.argmax's order: the first
// NaN, else the largest, else the first index.
__device__ __forceinline__ bool km_before(float av, int ai, float bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an != bn) return an;
  if (an) return ai < bi;
  return av > bv || (av == bv && ai < bi);
}

// s[u] = the squared distance of point x to center c0 + u (centers past k
// repeat the last), summed over the coordinates in order as the first
// design summed them: 16-byte loads, the padding coordinates 0 on both.
// kD: the padded width D4 when the kernel was built for it (unrolled), else 0.
template <int kU, int kD>
__device__ __forceinline__ void km_dist(const float* __restrict__ x, const float* __restrict__ cen,
                                        int D4, int c0, int k, float (&s)[kU]) {
  const int D = kD > 0 ? kD : D4;
  const float* c[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    c[u] = cen + min(c0 + u, k - 1) * D;
    s[u] = 0.f;
  }
#pragma unroll(kD > 0 ? kD / 4 : 1)
  for (int j = 0; j < D; j += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + j);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float4 cv = *reinterpret_cast<const float4*>(c[u] + j);
      float t = xv.x - cv.x;
      s[u] = fmaf(t, t, s[u]);
      t = xv.y - cv.y;
      s[u] = fmaf(t, t, s[u]);
      t = xv.z - cv.z;
      s[u] = fmaf(t, t, s[u]);
      t = xv.w - cv.w;
      s[u] = fmaf(t, t, s[u]);
    }
  }
}

__device__ __forceinline__ void km_stamp(long long* probe, int at) {
  if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) probe[at] = clock64();
}

// One CTA a group. Shared: the points [S][stride] (stride = d rounded up to
// 4, then to 4 mod 8 floats, so a warp's 16-byte loads of 8 points hit 32
// distinct banks), the centers [k][D4], weights, running minimum distances,
// each cluster's members as bit masks [k][S / 32], per coordinate the
// points whose (0 * w) * x is NaN (a non-finite weight or coordinate), each
// point's center and the points sorted by center.
// kD: 64 for the UDA's 64 coordinates (the distance loops unrolled), else
// 0 (any width). Non-finite points or weights are rare: without them (a
// CTA-wide vote while loading) nothing counts the NaN terms.
template <int kD>
__global__ void __launch_bounds__(kKmThreads)
    kmeans_fit_kernel(const float* __restrict__ points, const float* __restrict__ weights, int S,
                      int d, int k, int iters, int vec, float* __restrict__ centers_out,
                      long long* __restrict__ probe) {
  extern __shared__ float4 km_sm[];
  const int D4 = kD > 0 ? kD : (d + 3) & ~3;
  const int stride = D4 % 8 == 0 ? D4 + 4 : D4;
  const int nch = (S + 31) / 32;
  float* pts = reinterpret_cast<float*>(km_sm);
  float* cen = pts + S * stride;
  float* w = cen + k * D4;
  float* mind = w + S;
  unsigned int* members = reinterpret_cast<unsigned int*>(mind + S);
  int* nf = reinterpret_cast<int*>(members + k * nch);
  int* asg = nf + D4;  // [S]: each point's center
  int* by_center = asg + S;  // [S]: the points by center, in index order within one
  int* cstart = by_center + S;  // [k + 1]: where each center's points start in by_center
  __shared__ float red_v[kKmWarps];
  __shared__ int red_i[kKmWarps];
  __shared__ int nf_w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long g = blockIdx.x;
  const float inf = __int_as_float(0x7F800000);
  km_stamp(probe, 0);

  // The group's points, weights and first live point (0 when none is).
  const float* gp = points + g * S * d;
  bool bad_in = false;  // a non-finite coordinate or weight
  if (vec) {
    for (int q = tid; q < S * d / 4; q += kKmThreads) {
      const int e = 4 * q, p = e / d;
      const float4 v = __ldg(reinterpret_cast<const float4*>(gp) + q);
      bad_in |= !(km_finite(v.x) && km_finite(v.y) && km_finite(v.z) && km_finite(v.w));
      *reinterpret_cast<float4*>(pts + p * stride + (e - p * d)) = v;
    }
  } else {
    for (int e = tid; e < S * d; e += kKmThreads) {
      const int p = e / d;
      const float v = __ldg(gp + e);
      bad_in |= !km_finite(v);
      pts[p * stride + (e - p * d)] = v;
    }
  }
  if (D4 > d) {
    for (int e = tid; e < S * (D4 - d); e += kKmThreads) {
      const int p = e / (D4 - d);
      pts[p * stride + d + (e - p * (D4 - d))] = 0.f;
    }
  }
  for (int e = tid; e < k * D4; e += kKmThreads) cen[e] = 0.f;
  int first = INT_MAX;
  for (int p = tid; p < S; p += kKmThreads) {
    const float wp = __ldg(weights + g * S + p);
    w[p] = wp;
    bad_in |= !km_finite(wp);
    if (wp > 0.f) first = min(first, p);
  }
  first = __reduce_min_sync(0xFFFFFFFFu, first);
  if (lane == 0) red_i[warp] = first;
  const bool any_bad = __syncthreads_or(bad_in) != 0;
  first = INT_MAX;
#pragma unroll
  for (int x = 0; x < kKmWarps; ++x) first = min(first, red_i[x]);
  if (first == INT_MAX) first = 0;
  for (int j = tid; j < d; j += kKmThreads) cen[j] = pts[first * stride + j];
  if (any_bad) {
    for (int j = tid; j < d; j += kKmThreads) {
      int bad = 0, bad_w = 0;
      for (int p = 0; p < S; ++p) {
        const bool wf = km_finite(w[p]);
        bad += !(wf && km_finite(pts[p * stride + j]));
        bad_w += !wf;
      }
      nf[j] = bad;
      if (j == 0) nf_w = bad_w;
    }
  }
  __syncthreads();
  km_stamp(probe, 1);

  // Farthest-point seeding: each point's minimum distance to the centers
  // so far, kept and updated by the newest center alone (a minimum is
  // exact: the same as recomputing it, NaN included); dead points -inf;
  // the argmax by warp shuffles, then over the warps.
  for (int i = 1; i < min(k, S); ++i) {
    float bv = -inf;
    int bi = INT_MAX;
    for (int p = tid; p < S; p += kKmThreads) {
      float dist[1];
      km_dist<1, kD>(pts + p * stride, cen, D4, i - 1, k, dist);
      const float m = i == 1 ? dist[0] : km_nanmin(mind[p], dist[0]);
      mind[p] = m;
      const float key = w[p] > 0.f ? m : -inf;
      if (km_before(key, p, bv, bi)) {
        bv = key;
        bi = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xFFFFFFFFu, bv, off);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, bi, off);
      if (km_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
#pragma unroll
    for (int x = 1; x < kKmWarps; ++x) {
      if (km_before(red_v[x], red_i[x], bv, bi)) {
        bv = red_v[x];
        bi = red_i[x];
      }
    }
    for (int j = tid; j < d; j += kKmThreads) cen[i * D4 + j] = pts[bi * stride + j];
    __syncthreads();
  }
  km_stamp(probe, 2);

  long long t_assign = 0, t_update = 0;
  for (int it = 0; it < iters; ++it) {  // Lloyd
    const long long t0 = clock64();
    // Each point's center: the first NaN distance, else the first minimum;
    // then a warp's 32 points as one bit mask a cluster.
    for (int r = 0; r < (S + kKmThreads - 1) / kKmThreads; ++r) {
      const int p = r * kKmThreads + tid;
      int a = -1;
      if (p < S) {
        float bv = inf;
        bool nan = false;
        a = 0;
        for (int c0 = 0; c0 < k; c0 += 4) {
          float s4[4];
          km_dist<4, kD>(pts + p * stride, cen, D4, c0, k, s4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (c0 + u >= k) break;
            if (s4[u] != s4[u]) {
              if (!nan) {
                nan = true;
                a = c0 + u;
              }
            } else if (!nan && s4[u] < bv) {
              bv = s4[u];
              a = c0 + u;
            }
          }
        }
      }
      const int ch = r * kKmWarps + warp;  // = p / 32
      for (int c = 0; c < k; ++c) {
        const unsigned int m = __ballot_sync(0xFFFFFFFFu, a == c);
        if (lane == 0 && ch < nch) members[c * nch + ch] = m;
      }
      if (p < S) asg[p] = a;
    }
    __syncthreads();
    // A counting sort by center from the masks: each warp scans the
    // centers' counts by shuffles (warp 0 keeps the starts for the
    // update); a point's place is its center's start, then its center's
    // members before it.
    for (int r = 0; r < (S + kKmThreads - 1) / kKmThreads; ++r) {
      const int p = r * kKmThreads + tid;
      const int a = p < S ? asg[p] : -1;
      int start = 0, carry = 0;
      for (int c0 = 0; c0 < k; c0 += 32) {
        const int c = c0 + lane;
        int cnt = 0;
        if (c < k) {
          for (int x = 0; x < nch; ++x) cnt += __popc(members[c * nch + x]);
        }
        int incl = cnt;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
          if (lane >= off) incl += y;
        }
        const int excl = carry + incl - cnt;
        if (r == 0 && warp == 0 && c < k) cstart[c] = excl;
        const int mine = __shfl_sync(0xFFFFFFFFu, excl, (a - c0) & 31);
        if (a >= c0 && a < c0 + 32) start = mine;
        carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      if (r == 0 && warp == 0 && lane == 0) cstart[k] = carry;
      if (p < S) {
        const int ch = p >> 5;
        int at = start + __popc(members[a * nch + ch] & ((1u << (p & 31)) - 1u));
        for (int x = 0; x < ch; ++x) at += __popc(members[a * nch + x]);
        by_center[at] = p;
      }
    }
    __syncthreads();
    const long long t1 = clock64();
    // A thread a center and two coordinates (j, j + d/2): its members'
    // weighted sums in index order, four members' loads at a time; the
    // reference's onehot.T @ points but for the zero terms of the other
    // points, which add nothing unless one is NaN (0 * inf, 0 * NaN): then
    // the sum is NaN, as is the weight sum's for a non-finite weight
    // elsewhere. An empty cluster keeps its center.
    const int dh = (d + 1) >> 1;
    for (int o = tid; o < k * dh; o += kKmThreads) {
      const int c = o / dh, j = o - c * dh, j2 = j + dh;
      const bool two = j2 < d;
      const int cnt = cstart[c + 1] - cstart[c];
      const int* list = by_center + cstart[c];
      float sum = 0.f, sum2 = 0.f, wsum = 0.f;
      int bad = 0, bad2 = 0, bad_w = 0;
      for (int t = 0; t < cnt; t += 4) {
        float wq[4], xq[4], yq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* row = pts + list[min(t + q, cnt - 1)] * stride;
          wq[q] = w[list[min(t + q, cnt - 1)]];
          xq[q] = row[j];
          yq[q] = two ? row[j2] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (t + q >= cnt) break;
          sum += wq[q] * xq[q];
          sum2 += wq[q] * yq[q];
          wsum += wq[q];
          if (any_bad) {
            const bool wf = km_finite(wq[q]);
            bad += !(wf && km_finite(xq[q]));
            bad2 += !(wf && km_finite(yq[q]));
            bad_w += !wf;
          }
        }
      }
      if (any_bad && nf_w > bad_w) wsum = __int_as_float(0x7FC00000);
      if (!(wsum > 0.f)) continue;
      const float div = fmaxf(wsum, 1e-9f);
      cen[c * D4 + j] = (any_bad && nf[j] > bad ? __int_as_float(0x7FC00000) : sum) / div;
      if (two) cen[c * D4 + j2] = (any_bad && nf[j2] > bad2 ? __int_as_float(0x7FC00000) : sum2) / div;
    }
    __syncthreads();
    const long long t2 = clock64();
    t_assign += t1 - t0;
    t_update += t2 - t1;
  }
  km_stamp(probe, 3);
  if (probe != nullptr && blockIdx.x == 0 && tid == 0) {
    probe[4] = t_assign;
    probe[5] = t_update;
  }
  for (int o = tid; o < k * d; o += kKmThreads) {
    const int c = o / d;
    centers_out[g * k * d + o] = cen[c * D4 + (o - c * d)];
  }
}

}  // namespace

extern "C" {

int px_reservoir_priority(const void* words, long long n, const void* mask, const void* salt,
                          void* out, void* stream) {
  reservoir_priority_kernel<<<grid_for(n, 8), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)words, n, (const unsigned char*)mask, (const long long*)salt,
      (double*)out);
  return (int)cudaGetLastError();
}

// int64 words of G x S lists of k entries: keys, then int32 origins,
// counts and rows.
static long long list_words(long long G, int S, int k) {
  return G * S * k + (G * S * (k + 2) + 1) / 2;
}

// Carves ``scratch`` into G x S lists of k entries.
static TopkLists carve(void* scratch, long long G, int S, int k) {
  TopkLists l;
  l.S = S;
  l.key = static_cast<long long*>(scratch);
  l.org = reinterpret_cast<int*>(l.key + G * S * k);
  l.cnt = l.org + G * S * k;
  l.rows = l.cnt + G * S;
  return l;
}

// The bucketed path: one CTA a group.
int px_reservoir_topk(const void* st_vals, const void* st_pri, int G, int k, const void* row_vals,
                      const void* row_pri, const void* order, const void* offsets, void* out_vals,
                      void* out_pri, void* stream) {
  if (k < 1 || k > kTopkMaxK) return (int)cudaErrorInvalidValue;
  topk_rows_kernel<<<G, kTopkThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)st_vals, (const double*)st_pri, k, (const long long*)row_vals,
      (const double*)row_pri, (const long long*)order, (const long long*)offsets,
      (long long*)out_vals, (double*)out_pri);
  return (int)cudaGetLastError();
}

// The sort-free path: gids int32 [n] (G: not a candidate), rows in row
// order. C chunks, then M merges of C / M lists a group, then a CTA a group
// that merges the state and the M lists and adds the candidate rows to the
// state's count. scratch: int64 [list_words(G, C, k) + list_words(G, M, k)],
// any contents; thr: int64 [G], -1 on entry.
int px_reservoir_topk_rows(const void* st_vals, const void* st_pri, const void* st_count, int G,
                           int k, const void* row_vals, const void* row_pri, const void* gids,
                           long long n, int C, int M, void* scratch, void* thr, void* out_vals,
                           void* out_pri, void* out_count, void* stream) {
  if (k < 1 || G < 1 || G > kChunkMaxG || G * k > kTopkMaxK || C < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const TopkLists chunks = carve(scratch, G, C, k);
  const TopkLists mids = carve(static_cast<long long*>(scratch) + list_words(G, C, k), G, M, k);
  topk_chunk_kernel<<<C, kTopkThreads, 0, st>>>((const double*)st_pri, G, k, (const double*)row_pri,
                                                (const int*)gids, n, chunks, (long long*)thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_lists_kernel<false><<<G * M, kTopkThreads, 0, st>>>(
      (const long long*)st_vals, (const double*)st_pri, nullptr, k, (const long long*)row_vals,
      nullptr, chunks, mids, (long long*)thr, nullptr, nullptr, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_lists_kernel<true><<<G, kTopkThreads, 0, st>>>(
      (const long long*)st_vals, (const double*)st_pri, (const long long*)st_count, k,
      (const long long*)row_vals, nullptr, mids, mids, (long long*)thr, (long long*)out_vals,
      (double*)out_pri, (long long*)out_count);
  return (int)cudaGetLastError();
}

// H27's launch: out[0] CTAs, out[1] threads a CTA, out[2] dynamic shared
// bytes (points, centers, weights, minimum distances, member masks, NaN
// counts, assignments, the points by center and the centers' starts);
// over the card's opt-in limit, allow_smem's error stands.
int px_kmeans_fit_geometry(int G, int S, int d, int k, int* out) {
  const long long D4 = (d + 3) & ~3, stride = D4 % 8 == 0 ? D4 + 4 : D4;
  const long long words = (long long)S * stride + (long long)k * D4 + 4LL * S +
                          (long long)k * ((S + 31) / 32) + D4 + k + 1;
  out[0] = G;
  out[1] = kKmThreads;
  out[2] = (int)(words * 4);
  return 0;
}

// points f32 [G, S, d], weights f32 [G, S], centers f32 [G, k, d]; probe:
// null, or int64 [6]: CTA 0's clock64 at the start, after the load, after
// seeding and at the end, then its cycles in Lloyd's assign and update.
int px_kmeans_fit(const void* points, const void* weights, int G, int S, int d, int k, int iters,
                  void* centers, void* probe, void* stream) {
  if (G < 1 || S < 1 || d < 1 || k < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  int geo[3];
  px_kmeans_fit_geometry(G, S, d, k, geo);
  const int vec = d % 4 == 0 && (uintptr_t)points % 16 == 0;
  const auto kernel = (d + 3) / 4 == 16 ? kmeans_fit_kernel<64> : kmeans_fit_kernel<0>;
  cudaError_t err = px::allow_smem(kernel, (size_t)geo[2]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<geo[0], geo[1], geo[2], (cudaStream_t)stream>>>(
      (const float*)points, (const float*)weights, S, d, k, iters, vec, (float*)centers,
      (long long*)probe);
  return (int)cudaGetLastError();
}

}  // extern "C"
