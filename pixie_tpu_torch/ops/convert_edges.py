"""The resident ring's converters' (H24's) cases: the inputs on which the
card tests (tests/test_torch_kernels.py), the CPU tests
(tests/test_torch_resident.py) and chip_smoke.py hold
``kernels.ring_convert`` against ``codec.convert_block_plain`` and the
host pack, at one shard and over a window's D shards landed in their slice
of a one-card staging (``strided_staging``).

The kinds the ring paths convert (service codes and resp_status narrowed,
latency as f32 with NaN payloads of both signs, +-inf, +-0, f32 subnormals
and overflow, resp_status as int-dictionary codes) and the others the
plans can give (a narrowing to int32, LUTs of 256 and 65536 entries, a raw
int64 -> int32 cast).
"""

from __future__ import annotations

import numpy as np
import torch

F64_EDGES = np.array([
    0x7FF8000000000000, 0xFFF8000000000000, 0x7FF80000DEADBEEF, 0x7FF4000000000001,
    0xFFF0000000000001, 0x7FF0000000000000, 0xFFF0000000000000, 0x0000000000000000,
    0x8000000000000000, 0x36A0000000000000, 0xB6A8000000000000, 0x380FFFFFFFFFFFFF,
    0x47EFFFFFF0000000, 0x4800000000000000, 0x7FEFFFFFFFFFFFFF, 0x3FF0000010000000,
], dtype=np.uint64)

RING_CASES = ("narrow_i32_u8", "narrow_i64_u16", "narrow_i64_i32", "f32", "intdict_c3",
              "intdict_c256", "intdict_c65536", "raw_i64_i32")
SHARD_COUNTS = (1, 4, 8)  # a window's shards on one card (d:1, d:4, d:8)


def ring_case(name: str, rng, n: int, n_services: int = 16):
    """(raw numpy column, col_plan, the plan's block dtype, the narrow
    offset or None) of one H24 case at n rows."""
    if name == "narrow_i32_u8":  # service codes (http_data_ring, sketches_ring)
        return (rng.integers(0, n_services, n).astype(np.int32),
                ("narrow", (np.dtype(np.uint8), 0)), np.dtype(np.uint8), 0)
    if name == "narrow_i64_u16":  # resp_status (http_data_ring)
        a = rng.choice([200, 404, 500, 200 + 65535], n).astype(np.int64)
        return a, ("narrow", (np.dtype(np.uint16), 200)), np.dtype(np.uint16), 200
    if name == "narrow_i64_i32":
        a = rng.integers(-(1 << 40), -(1 << 40) + (1 << 31) - 1, n).astype(np.int64)
        return a, ("narrow", (np.dtype(np.int32), -(1 << 40))), np.dtype(np.int32), -(1 << 40)
    if name == "f32":  # latency (sketches_ring's t-digest)
        x = rng.exponential(3e7, n)
        x[: F64_EDGES.size] = F64_EDGES.view(np.float64)
        x[F64_EDGES.size : 2 * F64_EDGES.size] = -F64_EDGES.view(np.float64)
        return x, ("f32", None), np.dtype(np.float32), None
    if name.startswith("intdict"):  # resp_status (sketches_ring's cell lane)
        C = int(name.split("_c")[1])
        lut = (np.array([200, 404, 500], np.int64) if C == 3 else
               np.unique(rng.integers(-(1 << 50), 1 << 50, C + 64))[:C].astype(np.int64))
        dt = np.dtype(np.uint8 if C <= 256 else np.uint16)
        return lut[rng.integers(0, C, n)], ("intdict", (lut, dt)), dt, None
    if name == "raw_i64_i32":
        return (rng.integers(-(1 << 62), 1 << 62, n), ("raw", None), np.dtype(np.int32), None)
    raise ValueError(f"unknown ring case {name!r}")


def strided_staging(d: int, nblk: int, b: int, dtype: torch.dtype, device,
                    windows: int = 3, w: int = 1):
    """(a [d, windows * nblk, b] staging of ``dtype`` filled with a
    sentinel byte, window ``w``'s slice ``[:, w * nblk:(w + 1) * nblk]``):
    the out of one ring window's conversion into a stream's staging of d
    logical shards, d runs at the staging's shard stride."""
    size = torch.empty(0, dtype=dtype).element_size()
    staged = torch.full((d, windows * nblk, b * size), 0x5A, dtype=torch.uint8,
                        device=device).view(dtype)
    return staged, staged[:, w * nblk : (w + 1) * nblk]
