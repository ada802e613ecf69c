"""Measure the Fault-4 contract of the port's t-digest against the reference
on the CPU (the numbers PERF.md quotes for it).

    JAX_PLATFORMS=cpu python tools/fault4_probe.py

Prints:
1. how XLA-CPU's f32 ``arcsin`` (the reference's ``tdigest._k_scale``)
   compares with PyTorch's f32 asin, the f64 asin rounded to f32 (the port's
   plain version) and numpy's, over 2q - 1 for realistic mid-quantiles:
   its largest error in ulps and the share of values each candidate gives
   differently;
2. the cluster ids of the reference and of the port's plain version over 4M
   mid-quantiles: how many differ, and the largest distance of their f64
   coordinate k(q) * 256 from an integer;
3. the reference's standalone ``quantile_values`` against the port's plain
   version on the same random digest states;
4. the worst case the contract allows: config 5's query run twice through
   the port on the CPU, the second time with EVERY cluster id whose
   coordinate lies within 1e-4 of an integer pushed to the other side, and
   the largest relative move of a quantile, at three table/block sizes.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]
from pixie_tpu.ops import tdigest as ref_td  # noqa: E402
from pixie_tpu_torch.ops import tdigest  # noqa: E402

EPS = 1e-4


def mid_quantiles() -> np.ndarray:
    rng = np.random.default_rng(1)
    parts = [rng.random(3_000_000)]
    for c in (1000, 12_345, 1 << 20, 1 << 22):
        r = np.arange(0, c, max(1, c // 200_000))
        parts.append((r + 0.5) / c)
    return np.concatenate(parts).astype(np.float32)


def asin_candidates(q: np.ndarray) -> None:
    qc = np.clip(q, np.float32(1e-7), np.float32(1 - 1e-7))
    x = (np.float32(2.0) * qc - np.float32(1.0)).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.arcsin)(jnp.asarray(x)))
    exact = np.arcsin(x.astype(np.float64))

    def ulps(a):
        spacing = np.spacing(np.abs(a).astype(np.float32)).astype(np.float64)
        return float((np.abs(a.astype(np.float64) - exact) / spacing).max())

    t = torch.from_numpy(x)
    cands = {
        "torch f32 asin": torch.asin(t).numpy(),
        "f64 asin rounded to f32 (port, plain)": torch.asin(t.double()).float().numpy(),
        "numpy f32 arcsin": np.arcsin(x),
    }
    print(f"1. XLA-CPU f32 arcsin over {x.size} values: max error {ulps(ref):.3f} ulp")
    for name, v in cands.items():
        print(f"   {name}: max error {ulps(v):.3f} ulp, differs from XLA on "
              f"{(v != ref).mean():.4f} of values")


def cluster_ids(q: np.ndarray) -> None:
    want = np.asarray(jax.jit(lambda q: ref_td._cluster_ids(q, 256))(jnp.asarray(q)))
    got = tdigest._cluster_ids(torch.from_numpy(q), 256).numpy()
    qc = np.clip(q, np.float32(1e-7), np.float32(1 - 1e-7)).astype(np.float64)
    coord = (np.arcsin(2 * qc - 1) / math.pi + 0.5) * 256
    diff = got != want
    dist = np.abs(coord - np.round(coord))[diff]
    print(f"2. cluster ids over {q.size} mid-quantiles: {int(diff.sum())} differ "
          f"(max |id diff| {int(np.abs(got.astype(np.int64) - want).max())}), "
          f"largest distance of their coordinate from an integer "
          f"{dist.max() if dist.size else 0.0:.3g}")


def standalone_quantiles() -> None:
    rng = np.random.default_rng(3)
    qs = (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99)
    differ = total = 0
    for trial in range(20):
        st = ref_td.init(64)
        for _ in range(4):
            n = int(rng.integers(100, 5000))
            g = rng.integers(0, 64, n).astype(np.int32)
            m = rng.random(n) < rng.random()
            v = rng.exponential(3e7, n) + (5e7 if trial % 2 else 0.0)
            st = ref_td.update(st, jnp.asarray(g), jnp.asarray(v), jnp.asarray(m))
        want = np.asarray(ref_td.quantile_values(st, qs))
        got = tdigest.quantile_values(
            {k: torch.from_numpy(np.array(a)) for k, a in st.items()}, qs
        ).numpy()
        differ += int((got != want).sum())
        total += want.size
    print(f"3. standalone quantile_values on the same states: {differ} of {total} differ")


def worst_case(n: int, block_rows: int) -> None:
    from test_torch_sketch_queries import SKETCHES, http_events, run_port

    data = http_events(n, seed=42)
    base = run_port(data, SKETCHES, "sketches", block_rows=block_rows)
    orig = tdigest._cluster_ids
    flips = [0]

    def pushed(q, capacity):
        cl = orig(q, capacity)
        qc = torch.clamp(q.double(), 1e-7, 1 - 1e-7)
        c = (torch.asin(2 * qc - 1) / math.pi + 0.5) * capacity
        near = (c - torch.round(c)).abs() < EPS
        alt = torch.where(cl.double() >= torch.round(c), torch.round(c) - 1, torch.round(c))
        alt = torch.clamp(alt.to(torch.int32), 0, capacity - 1)
        flips[0] += int((near & (alt != cl)).sum())
        return torch.where(near, alt, cl)

    tdigest._cluster_ids = pushed
    try:
        moved = run_port(data, SKETCHES, "sketches", block_rows=block_rows)
    finally:
        tdigest._cluster_ids = orig
    rel = []
    for a, b in zip(base["lat"], moved["lat"]):
        a, b = json.loads(a), json.loads(b)
        rel += [abs(a[k] - b[k]) / abs(a[k]) for k in a]
    print(f"4. worst case at {n} rows, {block_rows}-row blocks: {flips[0]} ids pushed, "
          f"largest quantile move {max(rel):.3g} (relative)")


def main() -> None:
    q = mid_quantiles()
    asin_candidates(q)
    cluster_ids(q)
    standalone_quantiles()
    for n, b in ((200_000, 1 << 14), (1 << 20, 1 << 16), (1 << 20, 1 << 21)):
        worst_case(n, b)


if __name__ == "__main__":
    main()
