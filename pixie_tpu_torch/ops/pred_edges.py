"""H22's term tables: the slot terms (and edge columns) on which the CPU tests
(tests/test_torch_shared_scan.py), the card tests
(tests/test_torch_kernels.py) and chip_smoke.py hold
``batched.slot_masks`` (and ``batched.compile_terms``) against
``batched.slot_masks_plain``.

The soak's seven families of config 6's sum group (three status equalities,
a status inequality, a latency range, an op-6 list of two, a slot with no
term); ``wide_terms``: 16 or 32 slots that repeat them with one 1024-member
list in every slot past the seventh and a latency range of its own past the
fourteenth; one term on each of 16 columns of every staged dtype (pad terms
where a slot has fewer than T); and lists of every form (a bitmap of span
2^16, a sorted list in shared memory, one past the shared budget, an empty
list).
"""

from __future__ import annotations

import numpy as np

INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1


def edge_columns(n: int) -> dict:
    """{name: (array, offset)}: n rows of every staged dtype with their
    edges (INT64_MIN and INT64_MAX, NaN, +-0, +-inf, a subnormal, f32 0.1,
    uint16 at an offset of -70,000, codes from -1, bool), as SLOT_CASES
    name them."""
    rng = np.random.default_rng(11)
    i64 = rng.integers(INT64_MIN, INT64_MAX, n, dtype=np.int64, endpoint=True)
    i64[:6] = [INT64_MIN, INT64_MAX, 0, -1, 1, INT64_MIN + 1]
    f64 = rng.normal(0, 10, n)
    f64[:8] = [np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324, 1.5, -1.5]
    f32 = rng.normal(0, 10, n).astype(np.float32)
    f32[:4] = [np.float32(0.1), np.nan, -0.0, 0.0]
    u16 = rng.integers(0, 1 << 16, n).astype(np.uint16)
    codes = rng.integers(-1, 2000, n).astype(np.int32)
    flags_ = rng.random(n) < 0.5
    return {"i64": (i64, 0), "f64": (f64, 0), "f32": (f32, 0), "u16": (u16, -70_000),
            "codes": (codes, 0), "b": (flags_, 0)}


# Slot terms over edge_columns: int64 compares at INT64_MIN and
# INT64_MAX; f64 compares against 0.0, NaN, -0.0, inf and 1.5; f32, a
# narrowed uint16 with an offset, bool, op-6 lists of 3 and 1024 codes and
# a slot with no term; 32 slots.
SLOT_CASES = [
    [[("i", "i64", 0, INT64_MIN, 0.0, ())], [("i", "i64", 5, INT64_MAX, 0.0, ())],
     [("i", "i64", 2, 0, 0.0, ())]],
    [[("f", "f64", 0, 0, 0.0, ())], [("f", "f64", 1, 0, float("nan"), ())],
     [("f", "f64", 4, 0, -0.0, ())], [("f", "f64", 3, 0, float("inf"), ())],
     [("f", "f64", 1, 0, 1.5, ())]],
    [[("f", "f32", 0, 0, float(np.float64(np.float32(0.1))), ())],
     [("i", "u16", 4, -40_000, 0.0, ()), ("i", "b", 1, 0, 0.0, ())],
     [("i", "codes", 6, 0, 0.0, (-1, 5, 17))],
     [("i", "codes", 6, 0, 0.0, tuple(range(-1, 2046, 2)))],  # L = 1024
     []],  # no term: every base row
    [[("i", "u16", s % 6, -70_000 + 2000 * s, 0.0, ())] for s in range(32)],
]


def soak_terms(status: str = "resp_status", latency: str = "latency", s0: int = 200,
               lat: float = 2e7) -> list:
    """The sum group's seven families as the normalizer writes them
    (``status`` on the int stack at s0, s0 + 204 and s0 + 300, ``latency``
    on the float stack)."""
    st = lambda op, thr, vals=(): ("i", status, op, thr, 0.0, vals)
    return [[st(0, s0)], [st(0, s0 + 204)], [st(0, s0 + 300)], [st(1, s0)],
            [("f", latency, 4, 0, lat, ())], [st(6, 0, (s0, s0 + 204))], []]


def wide_terms(B: int, status: str = "resp_status", latency: str = "latency", s0: int = 200,
               lat: float = 2e7, lat_step: float = 1e6) -> list:
    """B slots of one to three terms: the soak's families, then further
    families with an op-6 list of 1024 members (every second value from
    s0 - 200) and a latency range (< lat_step * (s + 1))."""
    fams = soak_terms(status, latency, s0, lat)
    out = []
    for s in range(B):
        terms = list(fams[s % len(fams)])
        if s >= len(fams):
            terms.append(("i", status, 6, 0, 0.0, tuple(range(s0 - 200, s0 - 200 + 2048, 2))))
        if s >= 2 * len(fams):
            terms.append(("f", latency, 2, 0, float(lat_step * (s + 1)), ()))
        out.append(terms)
    return out


SIXTEEN_KINDS = (np.int64, np.int32, np.uint16, np.uint8, np.float64, np.float32, np.bool_)


def sixteen_columns(n: int, seed: int = 12) -> dict:
    """{name: (array, offset)}: 16 term columns c0..c15 of every staged
    dtype in turn, integer ones with an offset of 7 j."""
    rng = np.random.default_rng(seed)
    cols = {}
    for j in range(16):
        dt = SIXTEEN_KINDS[j % len(SIXTEEN_KINDS)]
        if dt == np.bool_:
            a = rng.random(n) < 0.5
        elif np.dtype(dt).kind == "f":
            a = rng.normal(0, 4, n).astype(dt)
        else:
            a = rng.integers(0, 50, n).astype(dt)
        cols[f"c{j}"] = (a, 7 * j if np.dtype(dt).kind in "iu" else 0)
    return cols


def sixteen_terms() -> list:
    """One term on each of ``sixteen_columns``' 16 columns, two a slot, then
    slots of one and of three terms (pad terms: T = 4)."""
    def term(j):
        if j % 7 in (4, 5):
            return ("f", f"c{j}", j % 6, 0, 0.5, ())
        if j % 7 == 3:
            return ("i", f"c{j}", 6, 0, 0.0, tuple(range(7 * j, 7 * j + 50, 3)))
        return ("i", f"c{j}", j % 6, 7 * j + 20, 0.0, ())
    return ([[term(2 * s), term(2 * s + 1)] for s in range(8)]
            + [[term(0)], [term(1), term(2), term(3)]])


def lists_terms(col: str = "i64", empty_col: str = "codes") -> list:
    """Op-6 lists of every form on an int64 column: a bitmap (span 2^16),
    a sorted list in shared memory (span above 2^16, INT64_MIN's
    neighbourhood), one past the shared budget, and an empty list (always
    false) on ``empty_col``."""
    wide = tuple(range(INT64_MIN + 7, INT64_MIN + 7 + 3000 * 100_003, 100_003))
    past = tuple(range(-4_000 * 1_000_003, 0, 1_000_003))
    return [[("i", col, 6, 0, 0.0, tuple(range(-(1 << 15), 1 << 15, 5)) + ((1 << 15) - 1,))],
            [("i", col, 6, 0, 0.0, wide + (0, -1))],
            [("i", col, 6, 0, 0.0, past + (1, INT64_MAX))],
            [("i", empty_col, 6, 0, 0.0, ())]]
