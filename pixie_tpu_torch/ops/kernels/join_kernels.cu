// The sort-merge join's kernels (H13-H15), built for Hopper (sm_90a) with the
// other kernel sources into one shared library that has a plain C interface
// (ops/kernels/__init__.py builds and binds it). ops/segment.py runs them in
// order: torch.sort orders the build keys (stable), H13 probes, torch.cumsum
// turns the fanouts into an inclusive prefix, H14 emits the pairs, H12
// (scan_kernels.cu) compacts the unmatched row indices, and H15 gathers each
// output column.
//
// H13 px_join_probe  replaces the two searchsorted and the fanout of
//    pixie_tpu/ops/segment.py merge_join_pairs (:524-530) and, for the
//    LEFT/OUTER variants, l_matched in local_sort_merge (:572-575).
//    Operation: for each probe row p, lo[p] = lower_bound(sorted, key[p]),
//    fanout[p] = upper_bound(sorted, key[p]) - lo[p] over the nb sorted build
//    keys. With a presence array (bytes, [present_size]), present[k] = 1 for
//    every probe key k in range, so a build row is matched iff present[its
//    key]: the reference's sort of the probe keys and two searchsorted, in
//    the pass over the probe keys already being read. Two lanes, by the key
//    space the caller passes (the join's keys are ids of [0, key_space)),
//    in one kernel:
//    - the table lane: each CTA of a persistent grid first builds lb[k] =
//      lower_bound(k) for k = 0 .. key_space in shared memory (key_space + 1
//      binary searches split across its threads; upper_bound(k) = lb[k + 1]
//      for integer keys), then takes its rows in a grid-stride loop, four a
//      thread at a time through 16-byte loads (two in flight) and stores,
//      with one shared lookup a row. Presence of ids 0-31 is a register a
//      thread, OR-ed across the warp at the end; of higher ids a bitmap in
//      shared memory (a thread that sees its bit set stores nothing); both
//      OR-ed into the global bytes once a CTA, at most one store a set id
//      (none once the byte shows 1). A key outside the table is searched.
//    - the search lane (no key space, one above kTableIds, or one whose
//      table would cost more than it saves): the same kernel with no table,
//      a row a thread, two dependent binary searches, a racing byte store a
//      new key.
//    The launcher tables a key space while its build, key_space + 1 searches
//    a CTA, costs less than the searches it saves: always up to 511 ids,
//    and up to kTableIds ids from kTableLaneRowsPerId probe rows an id on
//    (px_join_probe_geometry). The table's grid gives each CTA at least
//    kTableRowsPerId rows an id, so the builds stay a small share of the
//    work. What bounds it on an H100: each probe key read once and lo and
//    fanout written (12 bytes a row): bytes-bound in the table lane (one
//    shared lookup a row); in the search lane the log2(nb)-deep chains of
//    dependent loads a row, which over a large build side queue at the L2.
//
// H14 px_join_emit_pairs  replaces the pair emission of merge_join_pairs
//    (:531-540: slot -> probe row by a searchsorted of every slot over the
//    prefix, then the build position). Slot t of probe row p (prefix[p] -
//    fanout[p] <= t < prefix[p], t < cap) gets build_rows[t] =
//    order[clamp(lo[p] + t - (prefix[p] - fanout[p]), 0, nb - 1)] (the
//    reference's clamp) and probe_rows[t] = p. Two lanes, chosen on the host
//    from the build side's size, which bounds every fanout:
//    - the merge lane: emitting the pairs merges two ascending sequences, the
//      inclusive prefix of the n probe rows and the slots 0 .. min(M, cap) -
//      1 (M = prefix[n - 1]): row p is taken before slot t iff prefix[p] <= t.
//      Each CTA takes an equal share of that merge path, kEmitTile rows plus
//      slots. It finds where its share starts and ends by a radix-256 search
//      along its two diagonals (all its threads test prefix[q] + q < d
//      together, three rounds at 2^22 rows, on sample grids its neighbours
//      share), stages its rows' prefix and base (lo - first slot) in shared
//      memory, lets each thread merge kEmitItems items serially from its own
//      diagonal (a binary search in shared memory) to record each slot's
//      row, then writes its slots coalesced, consecutive slots of a row
//      reading order contiguously. So a row with a million pairs spreads over
//      as many CTAs as its slots fill, and a run of rows with no pair costs
//      only its share of the path.
//    - the row lane, while nb <= kRowsLaneBuild: a probe row a thread, its
//      pairs one store after another, kRowsPerThread rows a thread. No
//      fanout exceeds nb, so no thread writes more than kRowsLaneBuild pairs
//      a row, and a one-to-one join (config 8's 256-row build side) stays
//      one streaming pass without the merge lane's search and staging.
//    Slots are fixed by the prefix, not taken by atomics, so pairs stay
//    probe-row-major with the build rows of a key in their stable sort order,
//    and the result does not depend on scheduling or lane. Slots at or past
//    min(M, cap) are not written (no caller reads them). The merge lane's
//    grid is sized from n + cap on the host; a CTA past the path's end exits.
//    What bounds it: lo, fanout and prefix read once (12 bytes a probe row),
//    order read once a pair at most and 8 bytes written a pair: bytes-bound.
//    The merge lane's per-CTA search and staging cost about as much again at
//    one pair a row, which is why the row lane keeps the small build sides.
//
// H15 px_join_gather  replaces the output gathers of the reference's join
//    program (pixie_tpu/parallel/pipeline.py:3318-3346: gath, the null
//    sections and the concatenate). Operation, for one output column: out is
//    [cap_m | cap_r | cap_l] rows, the three sections of the matched pairs,
//    the unmatched probe rows and the unmatched build rows; row o of a
//    section with an index array reads src[clamp(idx[o], 0, nside - 1)], and
//    a section with no index array (the other side's rows of an outer
//    section) holds the null value. A column narrowed by staging (uint8,
//    uint16 or int32 of value - offset) is widened to int64 and the offset
//    added, in int64 here (torch has no uint16 arithmetic); other columns
//    (int32 codes, int64, f64, bool) are copied bit for bit. What bounds it:
//    the index (4 bytes) read and the row (up to 8 bytes) written once per
//    output row, the source column read once: bytes-bound; the gather's
//    reads are scattered only where the indices are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kJoinThreads = 256;
// H13: the most key ids its table holds (32 KB of lower bounds); the ids
// (key space + 1 bounds) it tables for any probe side, and the probe rows
// it needs for each id to table more (px_join_probe_geometry); the fewest
// rows a CTA takes, and the rows it takes at least for each id it tables.
constexpr int kTableIds = 8192;
constexpr int kTableAlwaysIds = 2 * kJoinThreads;
constexpr long long kTableLaneRowsPerId = 128;
constexpr long long kTableMinRows = 2048;
constexpr long long kTableRowsPerId = 16;
// H14: its lanes; the row lane's largest build side (so a thread's most
// pairs); the merge lane's items (probe rows plus pair slots) a thread and
// a CTA.
constexpr int kEmitRows = 0, kEmitMerge = 1;
constexpr int kRowsLaneBuild = 256;
constexpr int kRowsPerThread = 4;
constexpr int kEmitItems = 8;
constexpr int kEmitTile = kJoinThreads * kEmitItems;

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kJoinThreads - 1) / kJoinThreads);
}

inline bool aligned16(const void* p) { return ((unsigned long long)p & 15ull) == 0; }

// The first position of sorted[a, nb) whose key is >= k (lower) or > k.
__device__ __forceinline__ int lower_bound(const int* __restrict__ sorted, int a, int nb, int k) {
  int b = nb;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(sorted + mid) < k) a = mid + 1; else b = mid;
  }
  return a;
}

__device__ __forceinline__ int upper_bound(const int* __restrict__ sorted, int a, int nb, int k) {
  int b = nb;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(sorted + mid) <= k) a = mid + 1; else b = mid;
  }
  return a;
}

// The search lane's row: both bounds by binary search, presence by a byte
// store that a thread seeing the 1 already skips (every writer stores 1).
__device__ __forceinline__ void probe_search(const int* __restrict__ sorted, int nb, int k,
                                             int& lo, int& fanout, unsigned char* present,
                                             int present_size) {
  lo = lower_bound(sorted, 0, nb, k);
  fanout = upper_bound(sorted, lo, nb, k) - lo;
  if (present != nullptr && k >= 0 && k < present_size && present[k] == 0) present[k] = 1;
}

// kVec: keys, lo_out and fanout_out are 16-byte aligned. table_ids: the ids
// [0, table_ids) whose bounds the CTA tables (0: none, every key searched).
template <bool kVec>
__global__ void __launch_bounds__(kJoinThreads)
    join_probe_kernel(const int* __restrict__ sorted, int nb, const int* __restrict__ keys,
                      long long n, int* __restrict__ lo_out, int* __restrict__ fanout_out,
                      unsigned char* present, int present_size, int table_ids) {
  extern __shared__ int s_lb[];  // [table_ids + 1]
  __shared__ unsigned int s_bits[kTableIds / 32];
  const int bit_ids = present != nullptr ? min(table_ids, present_size) : 0;
  if (table_ids > 0) {  // the search lane's short CTAs skip the barrier
    for (int k = threadIdx.x; k <= table_ids; k += kJoinThreads) {
      s_lb[k] = lower_bound(sorted, 0, nb, k);
    }
    for (int w = threadIdx.x; w < (bit_ids + 31) / 32; w += kJoinThreads) s_bits[w] = 0u;
    __syncthreads();
  }
  unsigned int low = 0u;  // presence of ids 0-31, OR-ed across the warp at the end
  auto probe = [&](int k, int& lo, int& fanout) {
    if ((unsigned int)k < (unsigned int)table_ids) {
      lo = s_lb[k];
      fanout = s_lb[k + 1] - lo;
      if (k < bit_ids) {
        const unsigned int bit = 1u << (k & 31);
        if (k < 32) low |= bit;
        else if ((s_bits[k >> 5] & bit) == 0u) atomicOr(&s_bits[k >> 5], bit);
      }
    } else {
      probe_search(sorted, nb, k, lo, fanout, present, present_size);
    }
  };
  auto probe4 = [&](long long q, const int4& k) {
    int4 lo, fanout;
    probe(k.x, lo.x, fanout.x);
    probe(k.y, lo.y, fanout.y);
    probe(k.z, lo.z, fanout.z);
    probe(k.w, lo.w, fanout.w);
    reinterpret_cast<int4*>(lo_out)[q] = lo;
    reinterpret_cast<int4*>(fanout_out)[q] = fanout;
  };
  const long long stride = (long long)gridDim.x * kJoinThreads;
  const long long first = (long long)blockIdx.x * kJoinThreads + threadIdx.x;
  const long long quads = kVec ? n / 4 : 0;
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  for (long long q = first; q < quads; q += 2 * stride) {  // two loads in flight
    const bool two = q + stride < quads;
    const int4 ka = __ldg(keys4 + q);
    const int4 kb = two ? __ldg(keys4 + q + stride) : ka;
    probe4(q, ka);
    if (two) probe4(q + stride, kb);
  }
  for (long long p = quads * 4 + first; p < n; p += stride) {
    int lo, fanout;
    probe(__ldg(keys + p), lo, fanout);
    lo_out[p] = lo;
    fanout_out[p] = fanout;
  }
  if (bit_ids == 0) return;
  low = __reduce_or_sync(0xffffffffu, low);
  if ((threadIdx.x & 31) == 0 && low != 0u) atomicOr(&s_bits[0], low);
  __syncthreads();
  // A thread an id: every CTA sets the same few bytes, so a byte that already
  // shows 1 takes no store.
  for (int k = threadIdx.x; k < bit_ids; k += kJoinThreads) {
    if (((s_bits[k >> 5] >> (k & 31)) & 1u) != 0u && present[k] == 0) present[k] = 1;
  }
}

// H14's row lane (kEmitRows): a probe row a thread, its pairs written one
// after another, kRowsPerThread rows a thread (their loads issued together,
// a quarter of the CTAs). Taken only while nb <= kRowsLaneBuild, so no
// thread writes more than that many pairs a row.
__global__ void __launch_bounds__(kJoinThreads)
    join_emit_rows_kernel(const int* __restrict__ lo, const int* __restrict__ fanout,
                          const int* __restrict__ prefix, long long n,
                          const int* __restrict__ order, int nb, long long cap,
                          int* __restrict__ build_rows, int* __restrict__ probe_rows) {
  const long long first = (long long)blockIdx.x * kJoinThreads * kRowsPerThread + threadIdx.x;
  int f[kRowsPerThread], end[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long p = first + k * kJoinThreads;
    const bool in = p < n;
    f[k] = in ? __ldg(fanout + p) : 0;
    end[k] = in ? __ldg(prefix + p) : 0;
    l[k] = in ? __ldg(lo + p) : 0;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long start = (long long)end[k] - f[k];
    for (int j = 0; j < f[k]; ++j) {
      const long long slot = start + j;
      if (slot >= cap) break;
      int pos = l[k] + j;
      pos = pos < 0 ? 0 : (pos >= nb ? nb - 1 : pos);
      build_rows[slot] = __ldg(order + pos);
      probe_rows[slot] = (int)(first + k * kJoinThreads);
    }
  }
}

// H14's merge lane (kEmitMerge).
__global__ void __launch_bounds__(kJoinThreads)
    join_emit_pairs_kernel(const int* __restrict__ lo, const int* __restrict__ fanout,
                           const int* __restrict__ prefix, long long n,
                           const int* __restrict__ order, int nb, long long cap,
                           int* __restrict__ build_rows, int* __restrict__ probe_rows) {
  __shared__ int s_end[kEmitTile + 1];    // the window's inclusive prefix
  __shared__ int s_base[kEmitTile + 1];   // lo - the row's first slot
  __shared__ unsigned short s_row[kEmitTile];  // each slot's row in the window
  const int tid = threadIdx.x;
  const long long match = __ldg(prefix + n - 1);  // M, read beside the search
  // The CTA's diagonals, bounded by n + cap until M arrives. Row q lies before
  // diagonal d on the path iff prefix[q] + q < d (strictly increasing in q).
  // The last such row is found a radix-256 digit a round: each thread tests
  // the sample last + tid * 2^shift and the CTA counts the hits. The samples
  // depend only on the round and the digits found so far, so the CTAs of a
  // stretch of the path read the same few sectors.
  const long long d0 = (long long)blockIdx.x * kEmitTile;
  const long long d1 = min(d0 + kEmitTile, n + cap);
  int shift = 0;
  while ((256ll << shift) < n) shift += 8;
  long long last0 = 0, last1 = 0;
  bool any0 = true, any1 = true;  // whether any row lies before the diagonal
  for (;;) {
    const long long q0 = last0 + ((long long)tid << shift);
    const long long q1 = last1 + ((long long)tid << shift);
    const bool h0 = any0 && q0 < n && (long long)__ldg(prefix + q0) + q0 < d0;
    const bool h1 = any1 && q1 < n && (long long)__ldg(prefix + q1) + q1 < d1;
    const int c0 = __syncthreads_count(h0), c1 = __syncthreads_count(h1);
    if (c0 == 0) any0 = false; else last0 += (long long)(c0 - 1) << shift;
    if (c1 == 0) any1 = false; else last1 += (long long)(c1 - 1) << shift;
    if (shift == 0) break;
    shift = shift > 8 ? shift - 8 : 0;
  }
  const long long slots = min(match, cap), total = n + slots;
  if (d0 >= total) return;
  const long long p0 = max(any0 ? last0 + 1 : 0, d0 - slots), t0 = d0 - p0;
  long long p1 = n, t1 = slots;  // the path's end
  if (d1 < total) {
    p1 = max(any1 ? last1 + 1 : 0, d1 - slots);
    t1 = d1 - p1;
  }
  const int nrows = (int)(p1 - p0), nslots = (int)(t1 - t0);
  // The window: rows p0 .. p1 (p1 is the row of the share's last slots when
  // they do not end it).
  const int wrows = (int)min((long long)nrows + 1, n - p0);
  for (int i = tid; i < wrows; i += kJoinThreads) {
    const long long p = p0 + i;
    const int end = __ldg(prefix + p);
    s_end[i] = end;
    s_base[i] = __ldg(lo + p) - (end - __ldg(fanout + p));
  }
  __syncthreads();
  // Each thread's diagonal in the share, its row count by binary search in
  // shared memory (row i before diagonal e iff s_end[i] + i < t0 + e), then
  // its kEmitItems steps of the merge.
  const int items = nrows + nslots;
  const int e = min(tid * kEmitItems, items);
  int a = max(0, e - nslots), b = min(e, nrows);
  while (a < b) {
    const int mid = (a + b) >> 1;
    if ((long long)s_end[mid] + mid < t0 + e) a = mid + 1; else b = mid;
  }
  int i = a, j = e - a;
  const int stop = min(e + kEmitItems, items);
  for (int k = e; k < stop; ++k) {
    if (j < nslots && (i >= nrows || (long long)s_end[i] > t0 + j)) {
      s_row[j++] = (unsigned short)i;
    } else {
      ++i;
    }
  }
  __syncthreads();
  for (int s = tid; s < nslots; s += kJoinThreads) {
    const int r = s_row[s];
    const long long t = t0 + s;
    long long pos = (long long)s_base[r] + t;
    pos = pos < 0 ? 0 : (pos >= nb ? nb - 1 : pos);
    build_rows[t] = __ldg(order + pos);
    probe_rows[t] = (int)(p0 + r);
  }
}

// in_bytes: the source element size; widen: 1 to read it as uint8, uint16 or
// int32 (by size) and write int64 value + offset, 0 to copy it as it is.
__global__ void __launch_bounds__(kJoinThreads)
    join_gather_kernel(const void* __restrict__ src, long long nside, int in_bytes, int widen,
                       long long offset, const int* __restrict__ idx_m, long long cap_m,
                       const int* __restrict__ idx_r, long long cap_r,
                       const int* __restrict__ idx_l, long long cap_l, long long null_bits,
                       void* __restrict__ out) {
  const long long o = (long long)blockIdx.x * kJoinThreads + threadIdx.x;
  if (o >= cap_m + cap_r + cap_l) return;
  const int* idx;
  long long i;
  if (o < cap_m) {
    idx = idx_m;
    i = o;
  } else if (o < cap_m + cap_r) {
    idx = idx_r;
    i = o - cap_m;
  } else {
    idx = idx_l;
    i = o - cap_m - cap_r;
  }
  const int out_bytes = widen ? 8 : in_bytes;
  if (idx == nullptr || nside <= 0) {  // a null section
    switch (out_bytes) {
      case 1: static_cast<uint8_t*>(out)[o] = (uint8_t)null_bits; break;
      case 2: static_cast<uint16_t*>(out)[o] = (uint16_t)null_bits; break;
      case 4: static_cast<uint32_t*>(out)[o] = (uint32_t)null_bits; break;
      default: static_cast<long long*>(out)[o] = null_bits; break;
    }
    return;
  }
  long long r = idx[i];
  r = r < 0 ? 0 : (r >= nside ? nside - 1 : r);
  if (widen) {
    long long v;
    switch (in_bytes) {
      case 1: v = static_cast<const uint8_t*>(src)[r]; break;
      case 2: v = static_cast<const uint16_t*>(src)[r]; break;
      case 4: v = static_cast<const int*>(src)[r]; break;
      default: v = static_cast<const long long*>(src)[r]; break;
    }
    static_cast<long long*>(out)[o] = v + offset;
    return;
  }
  switch (in_bytes) {
    case 1: static_cast<uint8_t*>(out)[o] = static_cast<const uint8_t*>(src)[r]; break;
    case 2: static_cast<uint16_t*>(out)[o] = static_cast<const uint16_t*>(src)[r]; break;
    case 4: static_cast<uint32_t*>(out)[o] = static_cast<const uint32_t*>(src)[r]; break;
    default: static_cast<long long*>(out)[o] = static_cast<const long long*>(src)[r]; break;
  }
}

}  // namespace

extern "C" {

// H13's launch over n probe rows with a key space of key_space ids (0: none):
// out[0] CTAs, out[1] threads a CTA, out[2] dynamic shared bytes, out[3] the
// ids the table holds (0: none, the search lane). A CTA builds its table by
// ceil((key_space + 1) / kJoinThreads) searches a thread before its first
// row, so the table is taken where that costs less than the searches it
// saves: up to kTableAlwaysIds bounds (two searches a thread, a probe row's
// two) for any probe side, and up to kTableIds ids for a probe side of at
// least kTableLaneRowsPerId rows an id (PERF.md: measured on an H100 over
// key spaces of 22 to 16384 ids and probe sides of 256 to 4,194,304 rows).
int px_join_probe_geometry(long long n, int key_space, int* out) {
  const long long ids = (long long)key_space + 1;
  const bool table = key_space > 0 && key_space <= kTableIds &&
                     (ids <= kTableAlwaysIds || n >= kTableLaneRowsPerId * ids);
  out[1] = kJoinThreads;
  out[2] = table ? (int)ids * (int)sizeof(int) : 0;
  out[3] = table ? key_space : 0;
  if (!table) {  // the search lane: a row a thread, CTAs replaced as they end
    out[0] = (int)blocks_for(n > 0 ? n : 1);
    return 0;
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, join_probe_kernel<true>, kJoinThreads, (size_t)out[2]);
  if (err != cudaSuccess) return (int)err;
  const long long per_id = kTableRowsPerId * ids;
  const long long rows = per_id > kTableMinRows ? per_id : kTableMinRows;
  long long want = (n + rows - 1) / rows;
  const long long cap = (long long)px::num_sms() * (per_sm > 0 ? per_sm : 1);
  if (want > cap) want = cap;
  out[0] = want > 0 ? (int)want : 1;
  return 0;
}

// sorted: int32 [nb] build keys in ascending order; keys: int32 [n] probe
// keys; lo, fanout: int32 [n] out; present: uint8 [present_size], zeroed by
// the caller, or null (no presence); key_space: the ids [0, key_space) the
// keys are drawn from, or 0 (unknown: the search lane).
int px_join_probe(const void* sorted, int nb, const void* keys, long long n, void* lo,
                  void* fanout, void* present, int present_size, int key_space, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int geo[4];
  const int status = px_join_probe_geometry(n, key_space, geo);
  if (status != 0) return status;
  // The search lane takes the scalar loop, one row a thread: its rows'
  // chains of dependent loads, not its stores, set its time, and a grid of
  // a CTA per 256 rows keeps the SMs full to the end (on an H100, capped at
  // the persistent grid, it took up to 1.6x as long over 4,194,304 build
  // keys).
  const bool vec = geo[3] > 0 && aligned16(keys) && aligned16(lo) && aligned16(fanout);
  auto kernel = vec ? join_probe_kernel<true> : join_probe_kernel<false>;
  kernel<<<geo[0], geo[1], geo[2], (cudaStream_t)stream>>>(
      (const int*)sorted, nb, (const int*)keys, n, (int*)lo, (int*)fanout,
      (unsigned char*)present, present_size, geo[3]);
  return (int)cudaGetLastError();
}

// H14's launch over n probe rows, nb build rows and cap slots: out[0] CTAs,
// out[1] threads a CTA, out[2] dynamic shared bytes (none: the merge lane's
// window is static), out[3] the lane (kEmitRows while nb <= kRowsLaneBuild,
// else kEmitMerge).
int px_join_emit_pairs_geometry(long long n, int nb, long long cap, int* out) {
  const int lane = nb <= kRowsLaneBuild ? kEmitRows : kEmitMerge;
  const long long per_cta = lane == kEmitRows ? (long long)kJoinThreads * kRowsPerThread
                                              : (long long)kEmitTile;
  const long long items = lane == kEmitRows ? (n > 0 ? n : 1) : n + cap;
  out[0] = (int)((items + per_cta - 1) / per_cta);
  out[1] = kJoinThreads;
  out[2] = 0;
  out[3] = lane;
  return 0;
}

// lo, fanout, prefix (inclusive): int32 [n]; order: int32 [nb] build row of
// each sorted position; build_rows, probe_rows: int32 [cap] out.
int px_join_emit_pairs(const void* lo, const void* fanout, const void* prefix, long long n,
                       const void* order, int nb, long long cap, void* build_rows,
                       void* probe_rows, void* stream) {
  if (n <= 0 || cap <= 0 || nb <= 0) return (int)cudaSuccess;
  int geo[4];
  px_join_emit_pairs_geometry(n, nb, cap, geo);
  auto kernel = geo[3] == kEmitRows ? join_emit_rows_kernel : join_emit_pairs_kernel;
  kernel<<<geo[0], geo[1], geo[2], (cudaStream_t)stream>>>(
      (const int*)lo, (const int*)fanout, (const int*)prefix, n, (const int*)order, nb, cap,
      (int*)build_rows, (int*)probe_rows);
  return (int)cudaGetLastError();
}

// src: [nside] elements of in_bytes (1, 2, 4 or 8); idx_m/idx_r/idx_l: int32
// [cap_*] or null (a null section); out: [cap_m + cap_r + cap_l] elements of
// 8 bytes (widen) or in_bytes.
int px_join_gather(const void* src, long long nside, int in_bytes, int widen, long long offset,
                   const void* idx_m, long long cap_m, const void* idx_r, long long cap_r,
                   const void* idx_l, long long cap_l, long long null_bits, void* out,
                   void* stream) {
  if (in_bytes != 1 && in_bytes != 2 && in_bytes != 4 && in_bytes != 8) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = cap_m + cap_r + cap_l;
  if (total <= 0) return (int)cudaSuccess;
  join_gather_kernel<<<blocks_for(total), kJoinThreads, 0, (cudaStream_t)stream>>>(
      src, nside, in_bytes, widen, offset, (const int*)idx_m, cap_m, (const int*)idx_r, cap_r,
      (const int*)idx_l, cap_l, null_bits, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
