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
//    fanout[p] = upper_bound(sorted, key[p]) - lo[p], by binary search over
//    the nb sorted build keys. With a presence array (bytes, [present_size]),
//    present[key[p]] = 1 for every probe key in range, so a build row is
//    matched iff present[its key]: the same answer as the reference's sort of
//    the probe keys and two searchsorted, in one pass over the probe keys
//    already being read. Every writer stores the same 1, so the stores race
//    harmlessly; a thread that already sees the 1 stores nothing, so the
//    few hot bytes of a low-cardinality key space take few stores.
//    What bounds it on an H100: it reads each probe key once and writes lo
//    and fanout (12 bytes a row); the log2(nb) probes of each search hit the
//    sorted keys in L1/L2 (nb is the build side, small in the joins this
//    lane takes: 256 padded rows at bench.py's config 8). Bytes-bound.
//
// H14 px_join_emit_pairs  replaces the pair emission of merge_join_pairs
//    (:531-540: slot -> probe row by a searchsorted of every slot over the
//    prefix, then the build position). Here each probe row p with
//    fanout f > 0 writes its own f pairs, at slots prefix[p] - f + j for
//    j < f while the slot is below cap: build_rows[slot] = order[lo[p] + j]
//    (the position clamped to [0, nb), as the reference clamps it) and
//    probe_rows[slot] = p. Slots are fixed by the prefix, not taken by
//    atomics, so pairs stay probe-row-major with the build rows of a key in
//    their stable sort order, and the result does not depend on scheduling.
//    Slots at or past the match count are not written (no caller reads
//    them). What bounds it: lo, fanout and prefix read once (12 bytes a probe
//    row) and 8 bytes written a pair. One thread walks all of a row's pairs,
//    so one row with a huge fanout serialises on one thread; at config 8
//    every fanout is 0 or 1.
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

namespace {

constexpr int kJoinThreads = 256;

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kJoinThreads - 1) / kJoinThreads);
}

__global__ void __launch_bounds__(kJoinThreads)
    join_probe_kernel(const int* __restrict__ sorted, int nb, const int* __restrict__ keys,
                      long long n, int* __restrict__ lo_out, int* __restrict__ fanout_out,
                      unsigned char* present, int present_size) {
  const long long p = (long long)blockIdx.x * kJoinThreads + threadIdx.x;
  if (p >= n) return;
  const int k = keys[p];
  int a = 0, b = nb;
  while (a < b) {  // lower bound: the first position whose key is >= k
    const int mid = (a + b) >> 1;
    if (__ldg(sorted + mid) < k) a = mid + 1; else b = mid;
  }
  const int lo = a;
  b = nb;
  while (a < b) {  // upper bound, from the lower bound: the first key > k
    const int mid = (a + b) >> 1;
    if (__ldg(sorted + mid) <= k) a = mid + 1; else b = mid;
  }
  lo_out[p] = lo;
  fanout_out[p] = a - lo;
  if (present != nullptr && k >= 0 && k < present_size && present[k] == 0) present[k] = 1;
}

__global__ void __launch_bounds__(kJoinThreads)
    join_emit_pairs_kernel(const int* __restrict__ lo, const int* __restrict__ fanout,
                           const int* __restrict__ prefix, long long n,
                           const int* __restrict__ order, int nb, long long cap,
                           int* __restrict__ build_rows, int* __restrict__ probe_rows) {
  const long long p = (long long)blockIdx.x * kJoinThreads + threadIdx.x;
  if (p >= n) return;
  const int f = fanout[p];
  if (f <= 0) return;
  const long long start = (long long)prefix[p] - f;
  const int l = lo[p];
  for (int j = 0; j < f; ++j) {
    const long long slot = start + j;
    if (slot >= cap) break;
    int pos = l + j;
    pos = pos < 0 ? 0 : (pos >= nb ? nb - 1 : pos);
    build_rows[slot] = order[pos];
    probe_rows[slot] = (int)p;
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

// sorted: int32 [nb] build keys in ascending order; keys: int32 [n] probe
// keys; lo, fanout: int32 [n] out; present: uint8 [present_size], zeroed by
// the caller, or null (no presence).
int px_join_probe(const void* sorted, int nb, const void* keys, long long n, void* lo,
                  void* fanout, void* present, int present_size, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  join_probe_kernel<<<blocks_for(n), kJoinThreads, 0, (cudaStream_t)stream>>>(
      (const int*)sorted, nb, (const int*)keys, n, (int*)lo, (int*)fanout,
      (unsigned char*)present, present_size);
  return (int)cudaGetLastError();
}

// lo, fanout, prefix (inclusive): int32 [n]; order: int32 [nb] build row of
// each sorted position; build_rows, probe_rows: int32 [cap] out.
int px_join_emit_pairs(const void* lo, const void* fanout, const void* prefix, long long n,
                       const void* order, int nb, long long cap, void* build_rows,
                       void* probe_rows, void* stream) {
  if (n <= 0 || cap <= 0 || nb <= 0) return (int)cudaSuccess;
  join_emit_pairs_kernel<<<blocks_for(n), kJoinThreads, 0, (cudaStream_t)stream>>>(
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
