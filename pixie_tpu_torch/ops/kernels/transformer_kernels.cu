// The transformer UDF's encoder (K21), built for Hopper (sm_90a) with the
// other kernel sources into one shared library that has a plain C
// interface (ops/kernels/__init__.py builds and binds it). It launches on
// the CUDA runtime's current device and the caller's stream, allocates
// nothing, and returns the cudaError_t of its launch.
//
// H28 px_encoder_forward replaces pixie_tpu/ops/transformer.py's jitted
//    forward (:76-102): per document, ids [64] (the +1 shift and pad id 0
//    applied by the caller) and its token count; x = embed[ids] + pos;
//    per layer h = x * ln1 / (|x| + 1e-6) * 8, Q, K, V = h Wq, h Wk, h Wv,
//    per head softmax(Q K^T / 4 + key bias (0, or -1e9 for a pad key)) V,
//    x += ctx Wo, h = x * ln2 / (|x| + 1e-6) * 8, x += relu(h W1) W2; then
//    the mean over the real tokens, divided by (|pooled| + 1e-6). Shapes:
//    L 64, d 64, 4 heads of 16, MLP 256, f32 throughout.
//
// Only real rows are computed. A pad key's weight is exp(-1e9 - m), exactly
// 0 in f32, and a pad row never reaches the pool, so a document's real rows
// need nothing of its pad rows: the result is the padded forward's up to
// the order of f32 sums.
//
// Design: the real rows of all documents packed end to end (row offsets
// from the caller's cumsum of the lengths). A tile is every document that
// starts in rows [k kCap, (k + 1) kCap): at most kCap + 63 < kRows rows,
// whole documents only. One persistent CTA an SM walks the tiles; a tile's
// activations stay in shared memory feature-major ([feature][row], row
// stride kLd), both layers run on them, and the tile's embeddings are
// pooled at the end. Every product is A [rows, 64] x a 64 x 64 weight
// panel (Wq, Wk, Wv, Wo, W1's four column blocks, W2's four row blocks: 12
// a layer), a thread computing an 8 x 4 micro-tile in registers, f32 FFMA
// on CUDA cores in index order (no TF32, no tensor cores); W2's panels add
// into one register accumulator, so its sum runs over all 256 hidden
// features in order. The panels go through shared memory with cp.async,
// double-buffered: the next panel loads while this one is used, and every
// document of the tile shares it. Attention stays inside each document
// over its real keys: a warp a query row, the scores and softmax in
// registers with shuffles. Bound: operations, the multiply-adds of the
// real rows (chip_smoke.py encoder_flops).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int L = 64, D = 64, H = 4, DH = 16, FF = 256;
constexpr int kEncThreads = 256;
constexpr int kCap = 64;         // a tile: the documents starting in [k kCap, (k + 1) kCap)
constexpr int kRows = 128;       // a tile's rows at most (kCap + L - 1, rounded up)
constexpr int kLd = kRows + 4;   // the row stride of a feature-major activation
constexpr int kPanel = D * D;    // a weight panel: 64 x 64 floats
constexpr int kPanelsPerLayer = 12;
// One layer's weights, packed: wq, wk, wv, wo [D, D], w1 [D, FF], w2 [FF, D],
// ln1, ln2 [D] (ops/transformer.py pack_layer).
constexpr int kWq = 0, kWo = 3 * D * D, kW1 = 4 * D * D;
constexpr int kW2 = kW1 + D * FF, kLn1 = kW2 + FF * D, kLn2 = kLn1 + D;
constexpr int kLayerFloats = kLn2 + D;
static_assert(kLayerFloats == 49280, "ops/kernels/__init__.py ENCODER_LAYER_FLOATS");
// Shared memory, in floats: x, h (also the attention's context), q (also the
// MLP's hidden block), k, v, each [D][kLd]; two weight panels.
constexpr int kAct = D * kLd;
constexpr int kX = 0, kH = kAct, kQ = 2 * kAct, kK = 3 * kAct, kV = 4 * kAct;
constexpr int kW = 5 * kAct;
constexpr int kSmemFloats = kW + 2 * kPanel;
static_assert(kCap + L - 1 <= kRows, "a tile's rows must fit kRows");
static_assert(kEncThreads == 2 * kRows, "rms_scale: two threads a row");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One step of a transposing warp reduction: lanes with bit O set keep
// values W..2W-1, the others 0..W-1, each adding its partner's.
template <int W, int O>
__device__ __forceinline__ void fold_lanes(float (&c)[DH], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int kk = 0; kk < W; ++kk) {
    const float send = up ? c[kk] : c[kk + W];
    c[kk] = (up ? c[kk + W] : c[kk]) + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Panel p (0..11) of a layer: its first float and row stride.
__device__ __forceinline__ const float* panel_src(const float* w, int p, int& ld) {
  if (p < 4) {  // wq, wk, wv, wo
    ld = D;
    return w + kWq + p * D * D;
  }
  const int j = (p - 4) >> 1;
  if (((p - 4) & 1) == 0) {  // W1's columns 64j .. 64j + 63
    ld = FF;
    return w + kW1 + j * D;
  }
  ld = D;  // W2's rows 64j .. 64j + 63
  return w + kW2 + j * D * D;
}

// The thread's share of a product [m, 64] x [64, 64]: an 8 x 4 micro-tile.
// A warp holds 32 rows x 32 columns: warps 2w and 2w + 1 the rows 32w ..
// 32w + 31, each half of the columns.
using Acc = float[8][4];

__device__ __forceinline__ int tile_col() {
  return (((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7)) * 4;
}

// The first row of the thread's micro-tile, or -1 when its warp's rows
// start at or past m.
__device__ __forceinline__ int tile_row(int m) {
  const int warp_row0 = (threadIdx.x >> 6) * 32;
  return warp_row0 < m ? warp_row0 + ((threadIdx.x >> 3) & 3) * 8 : -1;
}

// acc += A [rows, 64] x W [64, 64] on the thread's micro-tile: A
// feature-major in shared memory, W a panel; k in order.
__device__ __forceinline__ void product(const float* A, const float* W, int m, Acc& acc) {
  const int r0 = tile_row(m), c0 = tile_col();
  if (r0 < 0) return;
#pragma unroll 16
  for (int k = 0; k < D; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * kLd + r0);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * kLd + r0 + 4);
    const float4 w = *reinterpret_cast<const float4*>(W + k * D + c0);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

enum Epilogue { kStore, kRelu, kAdd };

// C's micro-tile (feature-major) from acc: =, = relu, or +=.
template <int kE>
__device__ __forceinline__ void write_tile(float* C, int m, const Acc& acc) {
  const int r0 = tile_row(m), c0 = tile_col();
  if (r0 < 0) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float4* p = reinterpret_cast<float4*>(C + (c0 + j) * kLd + r0 + 4 * q);
      float4 v = make_float4(acc[4 * q][j], acc[4 * q + 1][j], acc[4 * q + 2][j],
                             acc[4 * q + 3][j]);
      if (kE == kRelu) {
        v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      } else if (kE == kAdd) {
        const float4 o = *p;
        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
      }
      *p = v;
    }
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// h = x * ln / (|x| + 1e-6) * sqrt(D) over rows [0, m): two threads a row,
// each over half of the features (the norm's halves meet in `part`; ln is
// read once into `lns`).
__device__ void rms_scale(const float* x, const float* __restrict__ ln, float* h, float* part,
                          float* lns, int m) {
  const int half = threadIdx.x / kRows, r = threadIdx.x % kRows;
  const int f0 = half * (D / 2);
  if (threadIdx.x < D) lns[threadIdx.x] = ln[threadIdx.x];
  if (r < m) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: the loads overlap
#pragma unroll
    for (int f = 0; f < D / 2; ++f) {
      const float xv = x[(f0 + f) * kLd + r];
      s[f & 3] = fmaf(xv, xv, s[f & 3]);
    }
    part[half * kRows + r] = (s[0] + s[1]) + (s[2] + s[3]);
  }
  __syncthreads();
  if (r < m) {
    const float scale = 8.0f / (sqrtf(part[r] + part[kRows + r]) + 1e-6f);
#pragma unroll 8
    for (int f = f0; f < f0 + D / 2; ++f) h[f * kLd + r] = x[f * kLd + r] * lns[f] * scale;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kEncThreads, 1)
    encoder_forward_kernel(const int* __restrict__ ids, const int* __restrict__ lens,
                           const int* __restrict__ ends, int B,
                           const float* __restrict__ embed, const float* __restrict__ pos,
                           const float* __restrict__ layers, int n_layers,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float part[2 * kRows], lns[D];
  __shared__ unsigned char rbeg[kRows], rlen[kRows];
  __shared__ int rdoc[kRows];  // a row's document, from the tile's first
  __shared__ int rid[kRows];   // a row's token id
  __shared__ int t_d0, t_d1, t_row0, t_rows;
  float* x = sm + kX;
  float* h = sm + kH;
  float* q = sm + kQ;
  float* k = sm + kK;
  float* v = sm + kV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int per_tile = kPanelsPerLayer * n_layers;
  int s = 0;  // panels this CTA has used
  auto stage = [&](int c) {  // panel c of the CTA's sequence into buffer c & 1
    const int p = c % per_tile;
    int ld;
    const float* src = panel_src(layers + (long long)(p / kPanelsPerLayer) * kLayerFloats,
                                 p % kPanelsPerLayer, ld);
    float* dst = sm + kW + (c & 1) * kPanel;
#pragma unroll
    for (int i = 0; i < kPanel / 4 / kEncThreads; ++i) {
      const int idx = tid + i * kEncThreads, row = idx >> 4, c4 = (idx & 15) * 4;
      cp_async16(dst + row * D + c4, src + row * ld + c4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // The next panel in use: starts the one after it, waits for it.
  auto acquire = [&]() -> const float* {
    stage(s + 1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    return sm + kW + ((s++) & 1) * kPanel;
  };

  const int total = B > 0 ? ends[B - 1] : 0;
  const int tiles = total > 0 ? (total + kCap - 1) / kCap : 1;
  stage(0);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (tid == 0) {
      // The first document starting at or after row `lo`: starts are
      // ends - lens, nondecreasing.
      auto first_from = [&](int lo) {
        int a = 0, b = B;
        while (a < b) {
          const int m = (a + b) >> 1;
          if (ends[m] - lens[m] < lo) a = m + 1; else b = m;
        }
        return a;
      };
      const int d0 = first_from(tile * kCap);
      const int d1 = tile == tiles - 1 ? B : first_from((tile + 1) * kCap);
      t_d0 = d0;
      t_d1 = d1;
      t_row0 = d0 < B ? ends[d0] - lens[d0] : total;
      t_rows = d1 > d0 ? ends[d1 - 1] - t_row0 : 0;
    }
    __syncthreads();
    const int d0 = t_d0, d1 = t_d1, row0 = t_row0, rows = t_rows;
    const int m = (rows + 31) & ~31;  // rows computed: whole warps of the products
    for (int d = d0 + tid; d < d1; d += kEncThreads) {
      const int b = ends[d] - lens[d] - row0, l = lens[d];
      for (int t = 0; t < l; ++t) {
        rbeg[b + t] = (unsigned char)b;
        rlen[b + t] = (unsigned char)l;
        rdoc[b + t] = d - d0;
      }
    }
    __syncthreads();
    if (tid < rows) rid[tid] = ids[(long long)(d0 + rdoc[tid]) * L + tid - rbeg[tid]];
    __syncthreads();
    // Each thread a float4 of a row's embedding and position at a time.
#pragma unroll 4
    for (int e = tid; e < m * (D / 4); e += kEncThreads) {
      const int r = e >> 4, f = (e & 15) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);  // rows past the tile's: zeros
      if (r < rows) {
        const int t = r - rbeg[r];
        const float4 a = *reinterpret_cast<const float4*>(embed + (long long)rid[r] * D + f);
        const float4 p = *reinterpret_cast<const float4*>(pos + t * D + f);
        val = make_float4(a.x + p.x, a.y + p.y, a.z + p.z, a.w + p.w);
      }
      x[f * kLd + r] = val.x;
      x[(f + 1) * kLd + r] = val.y;
      x[(f + 2) * kLd + r] = val.z;
      x[(f + 3) * kLd + r] = val.w;
    }
    __syncthreads();

    for (int layer = 0; layer < n_layers; ++layer) {
      const float* w = layers + (long long)layer * kLayerFloats;
      Acc acc, acc2;
      rms_scale(x, w + kLn1, h, part, lns, m);
      for (int p = 0; p < 3; ++p) {  // q, k, v
        const float* W = acquire();
        zero(acc);
        product(h, W, m, acc);
        write_tile<kStore>(p == 0 ? q : p == 1 ? k : v, m, acc);
        __syncthreads();
      }
      // Attention: a warp a query row, over its document's real keys, the
      // four heads interleaved; lane j holds keys j and j + 32. The context
      // goes into h.
      for (int i = warp; i < rows; i += kEncThreads / 32) {
        const int b = rbeg[i], l = rlen[i];
        const bool in0 = lane < l, in1 = lane + 32 < l;
        float s0[H], s1[H];
#pragma unroll
        for (int hh = 0; hh < H; ++hh) {
          float a0 = 0.f, a1 = 0.f;  // past the document: in-bounds, discarded
          if (l > 32) {
#pragma unroll
            for (int dd = 0; dd < DH; ++dd) {
              const float qv = q[(hh * DH + dd) * kLd + i];
              a0 = fmaf(qv, k[(hh * DH + dd) * kLd + b + lane], a0);
              a1 = fmaf(qv, k[(hh * DH + dd) * kLd + b + lane + 32], a1);
            }
          } else {
#pragma unroll
            for (int dd = 0; dd < DH; ++dd) {
              a0 = fmaf(q[(hh * DH + dd) * kLd + i], k[(hh * DH + dd) * kLd + b + lane], a0);
            }
          }
          s0[hh] = in0 ? a0 / 4.0f : -INFINITY;
          s1[hh] = in1 ? a1 / 4.0f : -INFINITY;
        }
        float mx[H], sum[H];
#pragma unroll
        for (int hh = 0; hh < H; ++hh) mx[hh] = fmaxf(s0[hh], s1[hh]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int hh = 0; hh < H; ++hh) mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], o));
        }
#pragma unroll
        for (int hh = 0; hh < H; ++hh) {
          s0[hh] = in0 ? expf(s0[hh] - mx[hh]) : 0.f;
          s1[hh] = in1 ? expf(s1[hh] - mx[hh]) : 0.f;
          sum[hh] = s0[hh] + s1[hh];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int hh = 0; hh < H; ++hh) sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], o);
        }
#pragma unroll
        for (int hh = 0; hh < H; ++hh) {
          const float p0 = s0[hh] / sum[hh], p1 = s1[hh] / sum[hh];
          // Each lane weighs its keys' values in the head's 16 features,
          // then a transposing reduction over the lanes (16 shuffles) leaves
          // feature lane / 2's sum on lanes 2f and 2f + 1.
          const float* vh = v + hh * DH * kLd + b + lane;
          float c[DH];
#pragma unroll
          for (int dd = 0; dd < DH; ++dd) {  // rows past the document may hold anything
            float t = in0 ? p0 * vh[dd * kLd] : 0.f;
            if (l > 32 && in1) t = fmaf(p1, vh[dd * kLd + 32], t);
            c[dd] = t;
          }
          fold_lanes<8, 16>(c, lane);
          fold_lanes<4, 8>(c, lane);
          fold_lanes<2, 4>(c, lane);
          fold_lanes<1, 2>(c, lane);
          c[0] += __shfl_xor_sync(0xffffffffu, c[0], 1);
          if ((lane & 1) == 0) h[(hh * DH + (lane >> 1)) * kLd + i] = c[0];
        }
      }
      {
        const float* W = acquire();  // wo; its wait's barrier also ends the attention
        zero(acc);
        product(h, W, m, acc);
        write_tile<kAdd>(x, m, acc);
        __syncthreads();
      }
      rms_scale(x, w + kLn2, h, part, lns, m);
      zero(acc2);
      for (int j = 0; j < FF / D; ++j) {
        const float* W1 = acquire();  // hidden features 64j .. 64j + 63 into q
        zero(acc);
        product(h, W1, m, acc);
        write_tile<kRelu>(q, m, acc);
        __syncthreads();
        product(q, acquire(), m, acc2);  // W2's rows 64j .. 64j + 63
        __syncthreads();
      }
      write_tile<kAdd>(x, m, acc2);
      __syncthreads();
    }

    // The mean over each document's rows, then the unit norm.
    for (int d = d0 + warp; d < d1; d += kEncThreads / 32) {
      const int b = ends[d] - lens[d] - row0, l = lens[d];
      float s0 = 0.f, s1 = 0.f;
      for (int t = 0; t < l; ++t) {
        s0 += x[lane * kLd + b + t];
        s1 += x[(lane + 32) * kLd + b + t];
      }
      const float count = fmaxf((float)l, 1.0f);
      const float p0 = s0 / count, p1 = s1 / count;
      const float den = sqrtf(warp_sum(p0 * p0 + p1 * p1)) + 1e-6f;
      out[(long long)d * D + lane] = p0 / den;
      out[(long long)d * D + lane + 32] = p1 / den;
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace

extern "C" {

// ids int32 [B, 64]; lens int32 [B] (0..64); ends int32 [B], the inclusive
// cumsum of lens; embed f32 [V, 64]; pos f32 [64, 64]; layers f32
// [n_layers, kLayerFloats], embed and pos 16-byte aligned; out f32 [B, 64].
int px_encoder_forward(const void* ids, const void* lens, const void* ends, int B,
                       const void* embed, const void* pos, const void* layers, int n_layers,
                       void* out, void* stream) {
  if (n_layers <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  if ((uintptr_t)layers % 16 != 0 || (uintptr_t)embed % 16 != 0 || (uintptr_t)pos % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = px::allow_smem(encoder_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // One CTA an SM walks the tiles (at most one a document).
  int grid = px::num_sms();
  if (grid > B) grid = B;
  encoder_forward_kernel<<<grid, kEncThreads, smem, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)lens, (const int*)ends, B, (const float*)embed,
      (const float*)pos, (const float*)layers, n_layers, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
