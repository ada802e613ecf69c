"""Phase times of H3 (log_histogram_update) and H8 (tdigest_merge) on the
card, their earlier designs against the port's, at the main paths' shapes.

    python3 tools/h3_h8_phases.py [--out FILE.json]

Run from the repository root on a machine with an H100 and the CUDA
toolkit. The earlier designs are kept here, verbatim but for clock64
stamps and a count of global atomics: H8 as one CTA of 2C threads a group (an
all-pairs rank count, a Hillis-Steele scan, CTA-wide asinf clusters and a
per-cluster walk), H3 as one [S, nbins] u32 partial a CTA over grid_for(n,
2) CTAs (S = 16) or a global atomic a row (S = 64). They are built by nvcc
into pixie_tpu_torch/_build/ beside the port's library. For each kernel at
each shape it prints (and writes as JSON) the median device ms of 30 calls
(CUDA events behind a sleep kernel, chip_smoke.time_ms), the floor of an
empty kernel on the same grid, CTA 0's phases in microseconds (clock64
cycles over the SM clock's rate), H3's global atomics and H8's groups on
its exact branches; and it checks each pair of designs against each other
and the plain version (H3 exact off bin edges; H8's weights bit for bit
with the plain version on the card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pixie_tpu_torch.ops import histogram, kernels, tdigest  # noqa: E402

EARLIER_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr float kPiF = 3.14159265358979323846f;
__device__ __forceinline__ void stamp(long long* p, int k) {
  if (p != nullptr && blockIdx.x == 0 && threadIdx.x == 0) p[k] = clock64();
}
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ uint32_t sort_key(float x) {
  if (x != x) return 0xFFFFFFFFu;
  return order_key(x == 0.0f ? 0.0f : x);
}
__device__ __forceinline__ int cluster_id(float q, int C) {
  q = fminf(fmaxf(q, 1e-7f), (float)(1.0 - 1e-7));
  const float x = __fsub_rn(__fmul_rn(2.0f, q), 1.0f);
  const float k = __fadd_rn(__fdiv_rn(asinf(x), kPiF), 0.5f);
  const int c = __float2int_rz(floorf(__fmul_rn(k, (float)C)));
  return min(max(c, 0), C - 1);
}
// probe: [2] start, [3] loaded, [4] ranked, [5] scanned, [6] clusters, [7] sums.
__global__ void merge_kernel(const float* __restrict__ a_means, const float* __restrict__ a_weights,
                             const void* __restrict__ b0, const void* __restrict__ b1, int raw_b,
                             int C, float* __restrict__ out_means, float* __restrict__ out_weights,
                             long long* probe) {
  extern __shared__ unsigned long long sh_keys[];
  stamp(probe, 2);
  const int n2 = 2 * C;
  float* sm = (float*)(sh_keys + n2);
  float* sw = sm + n2;
  float* cum = sw + n2;
  int* cl = (int*)(cum + n2);
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * C;
  float mv, wv;
  if (t < C) {
    mv = a_means[base + t];
    wv = a_weights[base + t];
  } else if (raw_b) {
    wv = (float)((const double*)b0)[base + t - C];
    const float vs = (float)((const double*)b1)[base + t - C];
    mv = wv > 0.0f ? __fdiv_rn(vs, fmaxf(wv, 1.0f)) : 0.0f;
  } else {
    mv = ((const float*)b0)[base + t - C];
    wv = ((const float*)b1)[base + t - C];
  }
  const unsigned long long mine =
      ((unsigned long long)sort_key(wv > 0.0f ? mv : __int_as_float(0x7f800000)) << 32) | (unsigned)t;
  sh_keys[t] = mine;
  __syncthreads();
  stamp(probe, 3);
  int rank = 0;
  for (int j = 0; j < n2; ++j) rank += sh_keys[j] < mine;
  sm[rank] = mv;
  sw[rank] = wv;
  __syncthreads();
  stamp(probe, 4);
  cum[t] = sw[t];
  __syncthreads();
  for (int off = 1; off < n2; off <<= 1) {
    const float add = t >= off ? cum[t - off] : 0.0f;
    __syncthreads();
    cum[t] = __fadd_rn(cum[t], add);
    __syncthreads();
  }
  stamp(probe, 5);
  const float total = cum[n2 - 1];
  const float q = __fdiv_rn(__fsub_rn(cum[t], __fmul_rn(0.5f, sw[t])), fmaxf(total, 1.0f));
  cl[t] = cluster_id(q, C);
  __syncthreads();
  stamp(probe, 6);
  if (t < C) {
    float ws = 0.0f, ms = 0.0f;
    for (int j = 0; j < n2; ++j) {
      if (cl[j] == t) {
        ws = __fadd_rn(ws, sw[j]);
        ms = __fadd_rn(ms, __fmul_rn(sm[j], sw[j]));
      }
    }
    out_weights[base + t] = ws;
    out_means[base + t] = ws > 0.0f ? __fdiv_rn(ms, fmaxf(ws, 1e-9f)) : 0.0f;
  }
  __syncthreads();
  stamp(probe, 7);
}
__device__ __forceinline__ int log_bin(float vf, float min_value, float log_gamma, int nbins) {
  const float v = (vf != vf) ? vf : fmaxf(vf, min_value);
  const float x = floorf(logf(v / min_value) / log_gamma);
  int idx = (int)((unsigned int)__float2int_rz(x) + 1u);
  if (vf <= min_value) idx = 0;
  return min(max(idx, 0), nbins - 1);
}
// probe: [0] global atomics, [2] start, [3] zeroed, [4] rows, [5] flushed.
__global__ void hist_kernel(const float* __restrict__ values, long long n,
                            const int* __restrict__ gids, const unsigned char* __restrict__ mask,
                            int S, int nbins, float min_value, float log_gamma,
                            unsigned long long* __restrict__ state, int use_shared,
                            long long* probe) {
  extern __shared__ unsigned int sh_u32[];
  stamp(probe, 2);
  unsigned long long issued = 0;
  const long long cells = (long long)S * nbins;
  if (use_shared) {
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) sh_u32[c] = 0u;
    __syncthreads();
  }
  stamp(probe, 3);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && !mask[i]) continue;
    const int g = gids[i];
    if (g < 0 || g >= S) continue;
    const long long cell = (long long)g * nbins + log_bin(values[i], min_value, log_gamma, nbins);
    if (use_shared) {
      atomicAdd(&sh_u32[cell], 1u);
    } else {
      atomicAdd(&state[cell], 1ull);
      ++issued;
    }
  }
  if (!use_shared) stamp(probe, 4);
  if (use_shared) {
    __syncthreads();
    stamp(probe, 4);
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      const unsigned int v = sh_u32[c];
      if (v != 0u) {
        atomicAdd(&state[c], (unsigned long long)v);
        ++issued;
      }
    }
  }
  for (int w = 16; w >= 1; w >>= 1) issued += __shfl_xor_sync(0xFFFFFFFFu, issued, w);
  if (probe != nullptr && (threadIdx.x & 31) == 0 && issued != 0ull) {
    atomicAdd((unsigned long long*)&probe[0], issued);
  }
  __syncthreads();
  stamp(probe, 5);
}
static int grid_for(long long n, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (n + 511) / 512, cap = (long long)sms * per_sm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}
extern "C" int earlier_merge(const void* am, const void* aw, const void* b0, const void* b1,
                          int raw_b, int G, int C, void* om, void* ow, void* probe,
                          void* stream) {
  const size_t smem = (size_t)2 * C * (8 + 3 * 4 + 4);
  merge_kernel<<<G, 2 * C, smem, (cudaStream_t)stream>>>(
      (const float*)am, (const float*)aw, b0, b1, raw_b, C, (float*)om, (float*)ow,
      (long long*)probe);
  return (int)cudaGetLastError();
}
extern "C" int earlier_grid(long long n, int use_shared) { return grid_for(n, use_shared ? 2 : 8); }
extern "C" int earlier_hist(const void* values, long long n, const void* gids, const void* mask,
                         int S, int nbins, float min_value, float log_gamma, void* state,
                         int use_shared, void* probe, void* stream) {
  const size_t smem = use_shared ? (size_t)S * nbins * 4 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  hist_kernel<<<grid_for(n, use_shared ? 2 : 8), 512, smem, (cudaStream_t)stream>>>(
      (const float*)values, n, (const int*)gids, (const unsigned char*)mask, S, nbins, min_value,
      log_gamma, (unsigned long long*)state, use_shared, (long long*)probe);
  return (int)cudaGetLastError();
}
"""

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def earlier_library() -> ctypes.CDLL:
    """The earlier designs, built beside the port's library."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "earlier_h3_h8.cu")
    so = os.path.join(kernels.BUILD_DIR, "libearlier_h3_h8.so")
    with open(src, "w") as f:
        f.write(EARLIER_SOURCE)
    subprocess.run([kernels._nvcc(), "-O3", "-std=c++17", kernels.ARCH, "-Xcompiler", "-fPIC",
                    "-shared", src, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.earlier_merge.argtypes = [P, P, P, P, I, I, I, P, P, P, P]
    lib.earlier_hist.argtypes = [P, LL, P, P, I, I, F, F, P, I, P, P]
    lib.earlier_grid.argtypes = [LL, I]
    for fn in (lib.earlier_merge, lib.earlier_hist, lib.earlier_grid):
        fn.restype = ctypes.c_int
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def stamped(fn, words: int, dev) -> torch.Tensor:
    """The probe of ``fn(probe)``'s third call (the first two warm up)."""
    for _ in range(2):
        fn(torch.zeros(words, dtype=torch.int64, device=dev))
    probe = torch.zeros(words, dtype=torch.int64, device=dev)
    fn(probe)
    torch.cuda.synchronize()
    return probe


def h8_cases(dev) -> dict:
    """sketches' H8: a digest of three 2^21-row blocks (16 groups, mask)
    and a block's H7 sums."""
    rng = np.random.default_rng(19)
    n, G, C = chip_smoke.BLOCK_ROWS, chip_smoke.N_SERVICES, tdigest.DEFAULT_CAPACITY
    mask = torch.from_numpy(rng.random(n) < 0.97).to(dev)
    a = tdigest.init(G, dev)
    for _ in range(3):
        a = tdigest.update(a, torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev),
                           torch.from_numpy(rng.exponential(3e7, n)).to(dev), mask)
    g = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
    sums = kernels.tdigest_update_sums(torch.from_numpy(rng.exponential(3e7, n)).to(dev), g,
                                       mask, G, C)
    return {"a": a, "sums": sums, "G": G, "C": C}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="also write the results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    kernels.library()
    lib = earlier_library()
    khz = kernels.sm_clock_khz(dev)
    out = {"card": chip_smoke.nvidia_smi_line(), "sm_clock_khz": khz}
    print(out["card"], flush=True)

    # H8 at sketches' shape.
    c = h8_cases(dev)
    a, sums, G, C = c["a"], c["sums"], c["G"], c["C"]
    want = tdigest.merge_plain(a, tdigest.batch_from_sums(sums[0], sums[1]))
    om = torch.empty((G, C), dtype=torch.float32, device=dev)
    ow = torch.empty_like(om)

    def old_merge(probe=None):
        chip_smoke.check(lib.earlier_merge(
            a["means"].data_ptr(), a["weights"].data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), 1, G, C, om.data_ptr(), ow.data_ptr(),
            probe.data_ptr() if probe is not None else None, stream()) == 0, "earlier H8 launch")

    def new_merge(probe=None):
        return kernels.tdigest_merge(a["means"], a["weights"], sums[0], sums[1], raw_b=True,
                                     probe=probe)

    got = new_merge()
    old_merge()
    torch.cuda.synchronize()
    chip_smoke.check(torch.equal(got["weights"], want["weights"]), "H8 weights differ from plain")
    h8_names = ("load+classes", "rank", "scan", "clusters", "sums")
    rec = {}
    for name, fn, shape in (("earlier", old_merge, (G, 2 * C, 48 * C)),
                            ("port", new_merge, kernels.tdigest_merge_geometry(G, C))):
        probe = stamped(fn, kernels.TD_MERGE_PROBE, dev)
        rec[name] = {
            "ms": chip_smoke.time_ms(fn),
            "floor_ms": chip_smoke.time_ms(lambda: kernels.empty_launch(dev, *shape)),
            "phases_us": chip_smoke.probe_phases_us(probe, h8_names, 2, khz),
            "branch_groups": probe.cpu().tolist()[:2] if name == "port" else None,
            "weights_cells_moved_vs_plain": int((ow != want["weights"]).sum())
            if name == "earlier" else int((got["weights"] != want["weights"]).sum()),
        }
    out["tdigest_merge"] = dict(rec, shape=f"state[{G},{C}] + sums[2,{G},{C}]")
    print("H8", json.dumps(out["tdigest_merge"]), flush=True)

    # H3 at service_stats' shape (S = 16) and at S = 64 and 600.
    rng = np.random.default_rng(3)
    n = chip_smoke.BLOCK_ROWS
    spec = histogram.DEFAULT_SPEC
    lg = math.log(spec.gamma)
    lat = torch.from_numpy(rng.exponential(3e7, n).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.97).to(dev)
    h3_names = ("zero", "rows", "flush")
    out["log_histogram_update"] = {}
    for S in (16, 64, 600):
        g = torch.from_numpy(rng.integers(0, S, n).astype(np.int32)).to(dev)
        state = histogram.init(S, dev)
        use_shared = int(S * spec.nbins * 4 <= kernels.smem_optin_bytes(dev))

        def old_hist(probe=None):
            chip_smoke.check(lib.earlier_hist(
                lat.data_ptr(), n, g.data_ptr(), mask.data_ptr(), S, spec.nbins,
                spec.min_value, lg, state.data_ptr(), use_shared,
                probe.data_ptr() if probe is not None else None, stream()) == 0,
                "earlier H3 launch")

        def new_hist(probe=None):
            kernels.log_histogram_update(lat, g, mask, state, spec.min_value, lg, probe=probe)

        ref = histogram.init(S, dev)
        old_state = state
        old_hist()
        torch.cuda.synchronize()
        ref.copy_(old_state)
        state = histogram.init(S, dev)
        new_hist()
        torch.cuda.synchronize()
        chip_smoke.check(torch.equal(state, ref), f"H3 S={S}: the two designs differ")
        lane = kernels.h3_lane(S, spec.nbins, kernels.smem_optin_bytes(dev))[0]
        rec = {}
        for name, fn in (("earlier", old_hist), ("port", new_hist)):
            probe = stamped(fn, kernels.H3_PROBE, dev)
            p = probe.cpu().tolist()
            if name == "earlier":
                grid, threads = lib.earlier_grid(n, use_shared), 512
                smem = S * spec.nbins * 4 * use_shared
            else:
                grid, threads, smem = kernels.h3_geometry(dev, n, S, spec.nbins)
            rec[name] = {
                "ms": chip_smoke.time_ms(fn),
                "floor_ms": chip_smoke.time_ms(
                    lambda: kernels.empty_launch(dev, grid, threads, smem)),
                "grid": grid, "threads": threads, "smem": smem,
                "phases_us": chip_smoke.probe_phases_us(probe, h3_names, 2, khz),
                "global_atomics": p[0],
            }
        out["log_histogram_update"][f"S={S}"] = dict(rec, lane=lane, shape=f"values[{n}] S={S}")
        print(f"H3 S={S}", json.dumps(out["log_histogram_update"][f"S={S}"]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
