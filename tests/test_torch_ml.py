"""The ML lane of the port (pixie_tpu_torch/ops/ml.py and
udf/builtins/ml_ops.py) against the reference's (pixie_tpu/ops/ml.py,
udf/builtins/ml_ops.py) on the CPU, over the same numpy inputs.

Contracts. Priorities, reservoir states (values, priorities, counts) and
merges bit for bit, forced ties included (the state's slots first, then the
rows in row order). ``reservoir_sample`` through PxL: the JSON string-equal
to the reference's in every geometry that changes a salt: a filter (the
masked salt), several blocks (the same small ``block_rows`` on both
executors), several passes (a small ``device_group_state_budget_mb`` in both
packages' flags), a ringed table (``resident_ingest``), the host AggNode
(after a join, and on an engine without a device executor), and a query
batched by the shared-scan coordinator, equal to the same query alone.
k-means centers within 1e-5 absolute of the reference's (f32 sums in
another order), exact on duplicated points (the first-index tie rule);
``kmeans`` and ``kmeans_predict`` through PxL on both packages (the
reference's tests/test_ml.py cases), the parsed centers within 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import ml as ref_ml
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels, kmeans_edges, ml
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.serving import SharedScanCoordinator
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.builtins import NOT_PORTED
from pixie_tpu_torch.utils import flags

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

I64 = np.iinfo(np.int64)
BLOCK = 512


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype.itemsize == 8 else a


def _state_equal(port: dict, ref: dict) -> None:
    assert sorted(port) == sorted(ref)
    for key in ref:
        want = np.asarray(ref[key])
        got = port[key].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)


def _values(kind: str, rng, n: int) -> np.ndarray:
    if kind == "int64":
        x = rng.integers(I64.min, I64.max, n, dtype=np.int64)
        x[:5] = [I64.min, I64.max, (1 << 53) + 1, -(1 << 60) - 3, 0]
        return x
    x = rng.normal(0.0, 1e6, n)
    nan_payload = np.array([0x7FF8000000000001], np.int64).view(np.float64)[0]
    x[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, nan_payload]
    return x


# -- the priorities and the reservoir op by op ----------------------------------
@pytest.mark.parametrize("salt", [0, 12345, (1 << 40) + 7])
@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_priorities_bit_exact(kind, salt):
    rng = np.random.default_rng(1)
    v = _values(kind, rng, 5000)
    want = np.asarray(ref_ml._priorities(jnp.asarray(v), salt))
    got = ml.priorities(torch.from_numpy(v), salt).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    assert np.all((got >= 0) & (got < 1))
    mask = rng.random(5000) < 0.5
    masked = ml.priorities(torch.from_numpy(v), salt, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(masked[mask], got[mask])
    assert np.all(masked[~mask] == -np.inf)


@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_reservoir_update_bit_exact(kind):
    """Four blocks of 3000 rows into 7 groups, 70% masked in (the masked
    salt), ints beyond 2^53, NaN, +-0 and +-inf values."""
    rng = np.random.default_rng(2)
    G = 7
    ref_st = ref_ml.reservoir_init(G, dtype=jnp.int64 if kind == "int64" else jnp.float64)
    st = ml.reservoir_init(G, "cpu", dtype=torch.int64 if kind == "int64" else torch.float64)
    for _ in range(4):
        gids = rng.integers(0, G, 3000).astype(np.int32)
        v = _values(kind, rng, 3000)
        mask = rng.random(3000) < 0.7
        ref_st = ref_ml.reservoir_update(ref_st, jnp.asarray(gids), jnp.asarray(v), jnp.asarray(mask))
        st = ml.reservoir_update(st, torch.from_numpy(gids), torch.from_numpy(v),
                                 torch.from_numpy(mask))
        _state_equal(st, ref_st)
    # Unmasked, too (the reference's mask=None path).
    gids = rng.integers(0, G, 500).astype(np.int32)
    v = _values(kind, rng, 500)
    _state_equal(ml.reservoir_update(st, torch.from_numpy(gids), torch.from_numpy(v)),
                 ref_ml.reservoir_update(ref_st, jnp.asarray(gids), jnp.asarray(v)))
    assert list(ml.reservoir_finalize(st)) == list(ref_ml.reservoir_finalize(ref_st))


def test_reservoir_merge_forced_ties():
    """Equal priorities across and within the two sides: the first side's
    slots win, each side in slot order; -inf slots last."""
    pri_a = np.array([[0.9, 0.5, 0.5, -np.inf], [0.3, 0.3, 0.3, 0.3], [-np.inf] * 4])
    pri_b = np.array([[0.5, 0.5, 0.1, -np.inf], [0.3, 0.9, 0.3, 0.3], [0.2, 0.2, -np.inf, 0.2]])
    a = {"values": np.arange(12.0).reshape(3, 4), "priority": pri_a, "count": np.array([3, 4, 0])}
    b = {"values": 100 + np.arange(12.0).reshape(3, 4), "priority": pri_b,
         "count": np.array([2, 4, 3])}
    want = ref_ml.reservoir_merge({k: jnp.asarray(v) for k, v in a.items()},
                                  {k: jnp.asarray(v) for k, v in b.items()})
    got = ml.reservoir_merge({k: torch.from_numpy(v) for k, v in a.items()},
                             {k: torch.from_numpy(v) for k, v in b.items()})
    _state_equal(got, want)
    assert got["values"][0].tolist() == [0.0, 1.0, 2.0, 100.0]
    assert got["values"][1].tolist() == [105.0, 4.0, 5.0, 6.0]


def test_reservoir_update_ties_within_a_block():
    """Repeated (value, position) pairs cannot tie (the position salts them),
    so the tie rule inside a block is pinned through a merge of candidates
    with equal priorities fed directly, as the kernel phase does on the
    card; here the update keeps rows in row order among equal values."""
    st = ml.reservoir_init(1, "cpu", k=4)
    v = torch.full((10,), 7.0, dtype=torch.float64)
    out = ml.reservoir_update(st, torch.zeros(10, dtype=torch.int32), v)
    ref = ref_ml.reservoir_update(ref_ml.reservoir_init(1, k=4), jnp.zeros(10, jnp.int32),
                                  jnp.full(10, 7.0))
    _state_equal(out, ref)


def test_reservoir_finalize_drops_nonfinite_from_json():
    st = ml.reservoir_init(2, "cpu", k=4)
    st["values"][0] = torch.tensor([1.5, np.nan, np.inf, -2.0], dtype=torch.float64)
    st["priority"][0] = torch.tensor([0.9, 0.8, 0.7, 0.6], dtype=torch.float64)
    st["count"][0] = 9
    got = ml.reservoir_finalize(st)
    assert json.loads(got[0]) == {"count": 9, "sample": [1.5, -2.0]}
    assert json.loads(got[1]) == {"count": 0, "sample": []}
    want = ref_ml.reservoir_finalize({k: v.numpy() for k, v in st.items()})
    assert list(got) == list(want)


# -- H26's decompositions, modelled ----------------------------------------------
# H26 (ops/kernels/ml_kernels.cu) keeps a group's best k in a buffer that it
# cuts back to k when a step might overflow it, pruning a row at or below
# the k-th best of entries with earlier origins (the state's, or its own
# after a cut). The bucketed entry runs one such pass a group over the
# state and the group's rows. The sort-free entry cuts the rows in row order
# into C contiguous chunks, so each group's rows into C contiguous slices; a
# chunk also prunes strictly below any k-th best another chunk published,
# and merges then take the state and the C lists, whole lists a step. The
# models below do the same in plain Python at a small step (the kernel's is
# 1024 rows, its buffer two steps).
_STEP = 8
_CAP = 2 * _STEP


def _key(p: float) -> int:
    return int(p * 2.0**53) if p >= 0 else -1


def _cut(buf: list, k: int) -> None:
    buf.sort(key=lambda e: (-e[0], e[1]))
    del buf[k:]


def _feed(buf: list, thr: int, steps, k: int, pub) -> int:
    """Each step's items (key, origin) enter above ``thr`` and not below
    ``pub[0]``; a cut after a step that leaves k entries raises ``thr`` (and
    ``pub[0]``) to the k-th best. Returns ``thr``."""
    for step in steps:
        floor = pub[0] if pub is not None else -1
        buf.extend(e for e in step if e[0] > thr and e[0] >= floor)
        if len(buf) > _CAP - _STEP:
            _cut(buf, k)
            if len(buf) == k:
                thr = max(thr, buf[-1][0])
                if pub is not None:
                    pub[0] = max(pub[0], buf[-1][0])
    return thr


def _bucketed_model(state: dict, g: np.ndarray, pri: np.ndarray, v: np.ndarray) -> dict:
    """H26's bucketed entry: a stable sort of the gids, then one pass a
    group over the state's slots (origins 0..k-1) and the group's rows
    (origins k + bucketed position)."""
    G, k = state["values"].shape
    order = np.argsort(g, kind="stable")
    offsets = np.searchsorted(g[order], np.arange(G + 1))
    keys = [_key(p) for p in pri[order]]
    st_keys = [[_key(p) for p in row] for row in state["priority"]]
    out_v = np.zeros((G, k), state["values"].dtype)
    out_p = np.full((G, k), -np.inf)

    def rows(a: int, e: int) -> list:
        return [[(keys[r], k + r) for r in range(b, min(b + _STEP, e))]
                for b in range(a, e, _STEP)]

    for gid in range(G):
        lo, hi = int(offsets[gid]), int(offsets[gid + 1])
        buf = [(st_keys[gid][i], i) for i in range(k)]
        _feed(buf, min(st_keys[gid]), rows(lo, hi), k, None)
        _cut(buf, k)
        for i, (kk, o) in enumerate(buf):
            if kk >= 0:
                out_p[gid, i] = kk / 2.0**53
                out_v[gid, i] = state["values"][gid, o] if o < k else v[order[o - k]]
    counts = np.bincount(g, minlength=G + 1)[:G]
    return {"values": out_v, "priority": out_p, "count": state["count"] + counts}


def _grid_case(state_kind: str, layout: str, G: int = 5, k: int = 4, n: int = 300):
    """Priorities on a grid of 8 values (ties across every chunk edge),
    70% masked in; group 3 has no rows, or group 0 holds every row."""
    rng = np.random.default_rng(60)
    pri = np.floor(rng.random(n) * 8) / 8
    mask = rng.random(n) < 0.7
    gids = rng.choice([0, 1, 2, 4], n).astype(np.int32)
    if layout == "one_group":
        gids[:] = 0
    state = {"values": np.zeros((G, k)), "priority": np.full((G, k), -np.inf),
             "count": np.zeros(G, np.int64)}
    if state_kind == "full":
        state["priority"] = -np.sort(-np.floor(rng.random((G, k)) * 8) / 8, axis=1)
        state["values"] = rng.normal(0.0, 1.0, (G, k))
        state["count"] = rng.integers(k, 100, G)
    return state, gids, pri, mask, rng.normal(0.0, 1.0, n)


@pytest.mark.parametrize("layout", ["group_without_rows", "one_group"])
@pytest.mark.parametrize("state_kind", ["empty", "full"])
def test_h26_bucketed_model_bit_exact(state_kind, layout, monkeypatch):
    """The bucketed entry's pass equals the plain version and the
    reference's reservoir_update (fed the same priorities) bit for bit."""
    state, gids, pri, mask, v = _grid_case(state_kind, layout)
    G = state["values"].shape[0]
    g = np.where(mask, gids, G)
    assert layout == "one_group" or not np.any(g == 3)
    got = _bucketed_model(state, g, pri, v)
    tstate = {key: torch.from_numpy(np.asarray(x)) for key, x in state.items()}
    plain = ml.topk_rows_plain(tstate, torch.from_numpy(g.astype(np.int64)),
                               torch.from_numpy(np.where(mask, pri, -np.inf)), torch.from_numpy(v))
    _state_equal({key: torch.from_numpy(x) for key, x in got.items()},
                 {key: x.numpy() for key, x in plain.items()})
    monkeypatch.setattr(ref_ml, "_priorities", lambda values, salt: jnp.asarray(pri))
    want = ref_ml.reservoir_update({key: jnp.asarray(x) for key, x in state.items()},
                                   jnp.asarray(gids), jnp.asarray(v), jnp.asarray(mask))
    _state_equal({key: torch.from_numpy(x) for key, x in got.items()}, want)


def _chunk_model(state: dict, g: np.ndarray, pri: np.ndarray, v: np.ndarray, C: int,
                 M: int, chunk_order) -> dict:
    """H26's sort-free path for few groups: C chunks of the rows in row
    order, each keeping every group's best k in one buffer (cut per group),
    then M merges a group of contiguous runs of those lists, then a merge
    of the state and the M lists. Origins are k + the row index."""
    G, k = state["values"].shape
    n = g.shape[0]
    st_keys = [[_key(p) for p in row] for row in state["priority"]]
    state_min = [min(row) for row in st_keys]
    pub = [[-1] for _ in range(G)]
    lists = [[None] * C for _ in range(G)]
    for c in chunk_order(C):
        thr = list(state_min)
        buf = []
        lo, hi = n * c // C, n * (c + 1) // C

        def cut_groups(final: bool) -> None:
            for gid in range(G):
                own = [e for e in buf if e[2] == gid]
                _cut(own, k)
                if len(own) == k:
                    thr[gid] = max(thr[gid], own[-1][0])
                    pub[gid][0] = max(pub[gid][0], own[-1][0])
                buf[:] = [e for e in buf if e[2] != gid] + own

        for b in range(lo, hi, _STEP):
            floor = [p[0] for p in pub]
            for r in range(b, min(b + _STEP, hi)):
                gid, kr = int(g[r]), _key(pri[r])
                if gid < G and kr > thr[gid] and kr >= floor[gid]:
                    buf.append((kr, k + r, gid))
            if len(buf) > _CAP - _STEP:
                cut_groups(False)
        cut_groups(True)
        for gid in range(G):
            lists[gid][c] = sorted([(e[0], e[1]) for e in buf if e[2] == gid],
                                   key=lambda e: (-e[0], e[1]))
    out_v = np.zeros((G, k), state["values"].dtype)
    out_p = np.full((G, k), -np.inf)
    per = max(1, _STEP // k)
    for gid in range(G):
        mid = []
        for m in range(M):
            own = []
            runs = lists[gid][C * m // M:C * (m + 1) // M]
            _feed(own, state_min[gid], [sum(runs[s0:s0 + per], []) for s0 in
                                        range(0, len(runs), per)], k, [pub[gid][0]])
            _cut(own, k)
            mid.append(own)
        buf = [(st_keys[gid][i], i) for i in range(k)]
        _feed(buf, state_min[gid], [sum(mid[s0:s0 + per], []) for s0 in range(0, M, per)], k,
              [pub[gid][0]])
        _cut(buf, k)
        for i, (kk, o) in enumerate(buf):
            if kk >= 0:
                out_p[gid, i] = kk / 2.0**53
                out_v[gid, i] = state["values"][gid, o] if o < k else v[o - k]
    counts = np.bincount(g, minlength=G + 1)[:G]
    return {"values": out_v, "priority": out_p, "count": state["count"] + counts}


@pytest.mark.parametrize("chunk_order", ["forward", "reverse"])
@pytest.mark.parametrize("layout", ["group_without_rows", "one_group"])
@pytest.mark.parametrize("state_kind", ["empty", "full"])
@pytest.mark.parametrize("C, M", [(1, 1), (2, 1), (3, 1), (7, 2), (40, 5), (64, 5)])
def test_h26_chunk_model_bit_exact(C, M, state_kind, layout, chunk_order, monkeypatch):
    """The sort-free path (chunks of rows in row order, every group in one
    buffer, two merge levels) equals the plain version and the reference's
    reservoir_update bit for bit, in either order of the chunks; chunks
    running in reverse order publish a later chunk's k-th best first, which
    rows of equal key and earlier origin must still beat."""
    state, gids, pri, mask, v = _grid_case(state_kind, layout)
    G = state["values"].shape[0]
    g = np.where(mask, gids, G)
    order = (lambda C_: range(C_)) if chunk_order == "forward" else (lambda C_: range(C_)[::-1])
    got = _chunk_model(state, g, pri, v, C, M, order)
    tstate = {key: torch.from_numpy(np.asarray(x)) for key, x in state.items()}
    plain = ml.topk_rows_plain(tstate, torch.from_numpy(g.astype(np.int64)),
                               torch.from_numpy(np.where(mask, pri, -np.inf)), torch.from_numpy(v))
    _state_equal({key: torch.from_numpy(x) for key, x in got.items()},
                 {key: x.numpy() for key, x in plain.items()})
    monkeypatch.setattr(ref_ml, "_priorities", lambda values, salt: jnp.asarray(pri))
    want = ref_ml.reservoir_update({key: jnp.asarray(x) for key, x in state.items()},
                                   jnp.asarray(gids), jnp.asarray(v), jnp.asarray(mask))
    _state_equal({key: torch.from_numpy(x) for key, x in got.items()}, want)


def test_topk_scratch_words_hold_keys_origins_and_counts():
    for G, S, k in ((16, 33, 64), (1, 528, 1024), (3, 7, 1), (1, 1, 1)):
        assert kernels.topk_scratch_words(G, S, k) * 8 >= G * S * k * (8 + 4) + G * S * (4 + 4)


@pytest.mark.parametrize("G, k, want", [(16, 64, True), (64, 16, True), (65, 1, False),
                                        (16, 65, False), (1, 1024, True), (0, 64, False)])
def test_topk_rows_fits(G, k, want):
    assert kernels.topk_rows_fits(G, k) == want


@pytest.mark.parametrize("n, k, sms, want", [
    (1 << 21, 64, 132, (528, 33)),   # the main path: 528 chunks, 33 merges of 16 lists
    (1 << 21, 1, 132, (528, 1)),
    (1 << 21, 1024, 132, (528, 528)),
    (5000, 64, 132, (5, 1)),
    (0, 64, 132, (1, 1)),
])
def test_topk_chunks(n, k, sms, want):
    assert kernels.topk_chunks(n, k, sms) == want


# -- k-means ------------------------------------------------------------------------
def _clusters(rng, G: int, S: int, d: int, k: int) -> tuple:
    truth = rng.normal(0.0, 1.0, (k, d)).astype(np.float32) * 3
    lab = rng.integers(0, k, (G, S))
    pts = (truth[lab] + 0.05 * rng.normal(0.0, 1.0, (G, S, d))).astype(np.float32)
    w = (rng.random((G, S)) < 0.85).astype(np.float32)
    w[1, :20] = 0.0  # the first live point is not point 0
    pts[w == 0] = 0.0
    return pts, w


@pytest.mark.parametrize("k", [3, 8])
def test_kmeans_fit_batched_matches_reference(k):
    rng = np.random.default_rng(3)
    pts, w = _clusters(rng, 4, 128, 64, k)
    fit = jax.jit(jax.vmap(ref_ml.kmeans_fit, in_axes=(0, 0, None)), static_argnums=2)
    want = np.asarray(fit(jnp.asarray(pts), jnp.asarray(w), k))
    got = ml.kmeans_fit(torch.from_numpy(pts), torch.from_numpy(w), k).numpy()
    assert got.shape == (4, k, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    one = ml.kmeans_fit(torch.from_numpy(pts[0]), torch.from_numpy(w[0]), k).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_kmeans_fit_ties_take_the_first_index():
    """Exactly duplicated points: seeding's argmax and Lloyd's argmin both
    take the first index, so the centers are exact copies."""
    base = np.array([[0, 0], [0, 0], [4, 0], [4, 0], [0, 4], [0, 4], [4, 4], [4, 4]], np.float32)
    pts = np.stack([base, base[::-1].copy()])
    w = np.ones((2, 8), np.float32)
    fit = jax.vmap(ref_ml.kmeans_fit, in_axes=(0, 0, None))
    for k in (2, 3, 4):
        want = np.asarray(fit(jnp.asarray(pts), jnp.asarray(w), k))
        got = ml.kmeans_fit(torch.from_numpy(pts), torch.from_numpy(w), k).numpy()
        np.testing.assert_array_equal(got, want)


def _same_nan_close(got: np.ndarray, want: np.ndarray, atol: float = 1e-5) -> None:
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("k", [3, 20])  # 20 > S: centers past S stay 0
def test_kmeans_fit_nan_and_inf_match_reference(k):
    """The plain version against the reference, vmapped over the groups,
    where a point holds NaN or +-inf and where every point is dead: the
    same NaN pattern (a NaN distance wins the minimum and the argmax/argmin
    as the first NaN; 0 * NaN and 0 * inf poison the sums) and 1e-5
    elsewhere."""
    pts, w = kmeans_edges.nan_groups()
    fit = jax.vmap(ref_ml.kmeans_fit, in_axes=(0, 0, None))
    with np.errstate(invalid="ignore", over="ignore"):
        want = np.asarray(fit(jnp.asarray(pts), jnp.asarray(w), k))
        got = ml.kmeans_fit(torch.from_numpy(pts), torch.from_numpy(w), k).numpy()
    assert np.isnan(want).any(axis=(1, 2)).tolist()[:3] == [True] * 3  # every NaN group shows
    assert np.isinf(want[3:5]).any(axis=(1, 2)).all()  # and each inf group
    _same_nan_close(got, want)


def _h27_model(pts: np.ndarray, w: np.ndarray, k: int, iters: int = 10) -> tuple:
    """A step model of H27 (ml_kernels.cu) in f32: the first live point by
    a search; seeding's running minimum (np.minimum: NaN wins) updated by
    the newest center alone and its argmax as the kernel's key order (the
    first NaN, else the first maximum; dead points -inf); Lloyd's argmin
    (the first NaN, else the first minimum); each center's members summed
    in index order, NaN where a non-member's (0 * w) * x is NaN, counted as
    the kernel counts it. Returns (seeds, centers)."""
    G, S, d = pts.shape
    seeds = np.zeros((G, k, d), np.float32)
    out = np.zeros((G, k, d), np.float32)
    bad = lambda wv, xv: ~np.isfinite(wv)[:, None] | ~np.isfinite(xv)
    with np.errstate(invalid="ignore", over="ignore"):
        for g in range(G):
            x, wg = pts[g], w[g]
            live = wg > 0
            first = int(np.nonzero(live)[0][0]) if live.any() else 0
            cen = np.zeros((k, d), np.float32)
            cen[0] = x[first]
            dist = lambda c: ((x - c) ** 2).sum(axis=1, dtype=np.float32)
            mind = None
            for i in range(1, min(k, S)):
                dd = dist(cen[i - 1])
                mind = dd if mind is None else np.minimum(mind, dd)
                key = np.where(live, mind, -np.inf).astype(np.float32)
                nan = np.isnan(key)
                cen[i] = x[int(np.argmax(nan)) if nan.any() else int(np.argmax(key))]
            seeds[g] = cen
            nf, nf_w = bad(wg, x).sum(axis=0), int((~np.isfinite(wg)).sum())
            for _ in range(iters):
                D = np.stack([dist(cen[c]) for c in range(k)], axis=1)
                nanrow = np.isnan(D)
                a = np.where(nanrow.any(axis=1), np.argmax(nanrow, axis=1),
                             np.argmin(np.where(nanrow, np.inf, D), axis=1))
                for c in range(k):
                    mem = np.nonzero(a == c)[0]
                    sums, wsum = np.zeros(d, np.float32), np.float32(0)
                    for p in mem:
                        sums = sums + wg[p] * x[p]
                        wsum = np.float32(wsum + wg[p])
                    sums[nf > bad(wg[mem], x[mem]).sum(axis=0)] = np.nan
                    if nf_w > int((~np.isfinite(wg[mem])).sum()):
                        wsum = np.float32(np.nan)
                    if wsum > 0:
                        cen[c] = sums / max(wsum, np.float32(1e-9))
            out[g] = cen
    return seeds, out


@pytest.mark.parametrize("case", ["nan", "nan_k_over_S", "clusters", "ties"])
def test_h27_model_equals_plain(case):
    """The step model of H27's seeding (running minimum, NaN-first argmax)
    gives kmeans_fit_plain's seeds exactly (iters 0), and its Lloyd steps
    (member masks, non-finite counts) the plain centers' NaN pattern and
    1e-5 elsewhere."""
    if case.startswith("nan"):
        pts, w = kmeans_edges.nan_groups()
        k = 20 if case == "nan_k_over_S" else 3
    elif case == "clusters":
        pts, w = _clusters(np.random.default_rng(4), 3, 128, 64, 8)
        k = 8
    else:
        (pts, w), k = kmeans_edges.tie_groups(), 4
    seeds, got = _h27_model(pts, w, k)
    with np.errstate(invalid="ignore", over="ignore"):
        want_seeds = ml.kmeans_fit_plain(torch.from_numpy(pts), torch.from_numpy(w), k, 0).numpy()
        want = ml.kmeans_fit_plain(torch.from_numpy(pts), torch.from_numpy(w), k).numpy()
    np.testing.assert_array_equal(seeds, want_seeds)
    _same_nan_close(got, want)


# -- through PxL ------------------------------------------------------------------
SAMPLE = (
    "df = px.DataFrame(table='events')\n"
    "{filter}"
    "s = df.groupby(['svc']).agg(\n"
    "    lat=('latency', px.reservoir_sample),\n"
    "    big=('big', px.reservoir_sample),\n"
    "    st=('status', px.reservoir_sample),\n"
    "    n=('latency', px.count),\n"
    ")\n"
    "px.display(s, 'out')\n"
)


def _events(n: int = 6000, n_svc: int = 5, seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    lat = rng.exponential(3e7, n)
    lat[[5, 77, 301]] = [np.nan, np.inf, -0.0]
    return {
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "svc": np.array([f"svc-{i}" for i in rng.integers(0, n_svc, n)], dtype=object),
        "latency": lat,
        "big": rng.integers(1 << 55, 1 << 62, n, dtype=np.int64),
        "status": rng.choice([200, 301, 404, 500], n).astype(np.int64),  # staged narrowed
    }


def _rel(pkg):
    dt = RefDT if pkg == "ref" else DataType
    rel = RefRelation if pkg == "ref" else Relation
    return rel.of(("time_", dt.TIME64NS), ("svc", dt.STRING), ("latency", dt.FLOAT64),
                  ("big", dt.INT64), ("status", dt.INT64))


def _write(carnot, pkg: str, data: dict, chunk: int = 0) -> None:
    t = carnot.table_store.create_table("events", _rel(pkg))
    n = len(data["time_"])
    step = chunk or n
    for off in range(0, n, step):
        t.write_pydict({k: v[off : off + step] for k, v in data.items()})
    t.compact()
    t.stop()


def _port(data: dict, executor: bool = True, chunk: int = 0):
    ex = DeviceExecutor(device="cpu", block_rows=BLOCK) if executor else None
    c = Carnot(device_executor=ex, device="cpu")
    _write(c, "port", data, chunk)
    return c


def _ref(data: dict, executor: bool = True, chunk: int = 0):
    ex = (MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=BLOCK)
          if executor else None)
    c = RefCarnot(device_executor=ex)
    _write(c, "ref", data, chunk)
    return c


class _flags:
    """Sets flags in both packages, restored on exit."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        for k, v in self.kv.items():
            flags.set(k, v)
            ref_flags.set(k, v)

    def __exit__(self, *exc):
        for k in self.kv:
            flags.reset(k)
            ref_flags.reset(k)
        return False


def _assert_json_equal(got: dict, want: dict) -> None:
    assert got["svc"] == want["svc"]
    assert got["n"] == want["n"]
    assert got["lat"] == want["lat"]  # string-equal JSON
    assert got["big"] == want["big"]
    assert got["st"] == want["st"]


def _both(query: str, data: dict, executor: bool = True, chunk: int = 0) -> tuple:
    port, ref = _port(data, executor, chunk), _ref(data, executor, chunk)
    got = port.execute_query(query).table("out")
    want = ref.execute_query(query).table("out")
    if executor:
        assert port.device_executor.last_fold_ms is not None
        assert ref.device_executor.last_fold_ms is not None
        assert not ref.device_executor.fallback_errors
    return got, want


@pytest.mark.parametrize("geometry", ["one_block", "blocks", "filter", "passes"])
def test_reservoir_sample_json_equals_reference(geometry):
    data = _events(6000 if geometry != "one_block" else 400)
    filt = "df = df[df.latency > 2e7]\n" if geometry == "filter" else ""
    query = SAMPLE.format(filter=filt)
    budget = {"device_group_state_budget_mb": 0} if geometry == "passes" else {}
    if geometry == "passes":
        data = _events(6000, n_svc=20)
    kernels.reset_launches()
    with _flags(**budget):
        got, want = _both(query, data)
    _assert_json_equal(got, want)
    if geometry == "passes":
        assert len(got["svc"]) == 20
    for js in got["big"]:
        sample = json.loads(js)["sample"]
        assert sample and all(x > (1 << 53) for x in sample)  # ints round-trip exactly
        assert set(sample) <= set(data["big"].tolist())
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # the plain versions ran


def test_reservoir_sample_passes_split_the_salt():
    """With more groups than one pass holds, each pass folds its own state
    (its own salt): the port's pass plan is the reference's."""
    data = _events(6000, n_svc=20)
    with _flags(device_group_state_budget_mb=0):
        port = _port(data)
        ex = port.device_executor
        specs_caps = []
        real = ex._pass_plan
        ex._pass_plan = lambda specs, g: specs_caps.append(real(specs, g)) or real(specs, g)
        port.execute_query(SAMPLE.format(filter=""))
    assert specs_caps and specs_caps[0] == (8, 3)


def test_reservoir_sample_on_a_ringed_table():
    data = _events(20_000)
    with _flags(resident_ingest=True, resident_window_rows=4096):
        got, want = _both(SAMPLE.format(filter=""), data, chunk=2048)
    _assert_json_equal(got, want)


@pytest.mark.parametrize("route", ["no_executor", "after_join"])
def test_reservoir_sample_on_the_host_aggnode(route):
    """Fragments the device lanes decline: the host AggNode salts per batch
    in both packages."""
    data = _events(3000)
    if route == "no_executor":
        got, want = _both(SAMPLE.format(filter=""), data, executor=False, chunk=700)
        _assert_json_equal(got, want)
        return
    owners = {"svc": np.array([f"svc-{i}" for i in range(4)], dtype=object),
              "team": np.array(["t0", "t1", "t0", "t1"], dtype=object)}
    query = (
        "l = px.DataFrame(table='events')\n"
        "r = px.DataFrame(table='owners')\n"
        "j = l.merge(r, how='left', left_on=['svc'], right_on=['svc'], suffixes=['', '_r'])\n"
        "s = j.groupby(['team']).agg(lat=('latency', px.reservoir_sample),\n"
        "    big=('big', px.reservoir_sample), st=('status', px.reservoir_sample),\n"
        "    n=('latency', px.count))\n"
        "px.display(s, 'out')\n"
    )
    outs = []
    with _flags(device_join_min_rows=0):
        for pkg, make in (("port", _port), ("ref", _ref)):
            c = make(data)
            dt = RefDT if pkg == "ref" else DataType
            rel = (RefRelation if pkg == "ref" else Relation).of(("svc", dt.STRING),
                                                               ("team", dt.STRING))
            c.table_store.create_table("owners", rel).write_pydict(dict(owners))
            outs.append(c.execute_query(query).table("out"))
    got, want = outs
    assert got["team"] == want["team"] and len(got["team"]) == 3
    assert got["n"] == want["n"] and got["lat"] == want["lat"] and got["big"] == want["big"]
    assert got["st"] == want["st"]


class _Capture:
    """Stands in for an executor's coordinator: runs each query solo and
    keeps what it offered."""

    def __init__(self):
        self.calls = []

    def run(self, key, compute, batch_key=None, terms=None, compute_batch=None):
        solo = compute()
        self.calls.append(dict(key=key, batch_key=batch_key, terms=terms,
                               compute_batch=compute_batch, solo=solo))
        return solo


def test_reservoir_sample_batched_slots_equal_solo():
    """Three reservoir queries that differ only in a latency threshold batch
    into one ``_run_program_batched`` call; each slot's state leaves are
    bit-equal to the query alone, and the query alone is the reference's."""
    data = _events(6000)
    queries = [SAMPLE.format(filter=f"df = df[df.latency > {t}]\n") for t in (1e7, 2e7, 4e7)]
    flags.set("shared_scans", True)
    flags.set("shared_scan_predicate_batching", True)
    try:
        port = _port(data)
        ex = port.device_executor
        for q in queries:
            port.execute_query(q)
        cap = _Capture()
        ex._shared_scans = cap
        alone = [port.execute_query(q).table("out") for q in queries]
        ex._shared_scans = SharedScanCoordinator()
    finally:
        flags.reset("shared_scans")
        flags.reset("shared_scan_predicate_batching")
    calls = cap.calls
    assert len(calls) == 3 and all(c["terms"] is not None for c in calls)
    assert len({c["batch_key"] for c in calls}) == 1
    slots = calls[0]["compute_batch"]([c["terms"] for c in calls])
    for call, slot in zip(calls, slots):
        (vals_a, pres_a), cap_a = call["solo"]
        (vals_b, pres_b), cap_b = slot
        assert cap_a == cap_b and np.array_equal(pres_a, pres_b)
        assert len(vals_a) == len(vals_b) == 10  # 3 x 3 state leaves, then the count
        for x, y in zip(vals_a, vals_b):
            assert np.array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))
    ref = _ref(data)
    for q, got in zip(queries, alone):
        _assert_json_equal(got, ref.execute_query(q).table("out"))


def _ml_events(pkg: str, n: int = 600):
    """The reference's tests/test_ml.py table: two clusters of 2-d JSON
    embeddings around (0, 0) and (10, -5)."""
    dt = RefDT if pkg == "ref" else DataType
    c = RefCarnot() if pkg == "ref" else Carnot(device="cpu")
    rel = (RefRelation if pkg == "ref" else Relation).of(
        ("time_", dt.TIME64NS), ("svc", dt.STRING), ("emb", dt.STRING), ("v", dt.FLOAT64))
    t = c.table_store.create_table("events", rel)
    rng = np.random.default_rng(2)
    cl = rng.integers(0, 2, n)
    embs = np.array([json.dumps([float(10 * k + rng.normal(0, 0.2)),
                                 float(-5 * k + rng.normal(0, 0.2))]) for k in cl], dtype=object)
    t.write_pydict({
        "time_": np.arange(n),
        "svc": np.array(["a" if i % 2 else "b" for i in range(n)], dtype=object),
        "emb": embs,
        "v": rng.normal(50, 5, n),
    })
    t.compact()
    t.stop()
    return c, cl


@pytest.mark.parametrize("groups", ["", "groupby(['svc'])."])
def test_kmeans_uda_through_pxl_matches_reference(groups):
    query = ("df = px.DataFrame(table='events')\n"
             "df.k = 2\n"
             f"m = df.{groups}agg(model=('emb', 'k', px.kmeans))\n"
             "px.display(m, 'model')\n")
    got = _ml_events("port")[0].execute_query(query).table("model")
    want = _ml_events("ref")[0].execute_query(query).table("model")
    assert len(got["model"]) == len(want["model"]) == (2 if groups else 1)
    for g, w in zip(got["model"], want["model"]):
        g, w = json.loads(g), json.loads(w)
        assert g["k"] == w["k"] == 2
        np.testing.assert_allclose(g["centers"], w["centers"], rtol=0, atol=1e-5)
        for t in ([0.0, 0.0], [10.0, -5.0]):
            assert np.min(np.linalg.norm(np.asarray(g["centers"]) - t, axis=1)) < 1.0


def test_kmeans_state_stays_on_the_cpu():
    """The AggNode keeps kmeans' state on the CPU whatever the engine's
    device (``host_state``; ``init`` itself honours the device it is
    given), through growth and merge."""
    from pixie_tpu_torch.udf.registry import default_registry

    from pixie_tpu_torch import plan as p
    from pixie_tpu_torch.exec.agg_node import AggNode

    registry = default_registry()
    uda = registry.lookup_uda("kmeans", [DataType.STRING, DataType.INT64])
    assert uda.host_state and uda.string_args == "values"
    assert all(v.device.type == "meta" for v in uda.init(4, torch.device("meta")).values())
    rel = Relation.of(("service", DataType.STRING), ("emb", DataType.STRING), ("k", DataType.INT64))
    op = p.AggOp(groups=("service",), values=(
        ("model", p.AggregateExpression("kmeans", (p.ColumnRef("emb"), p.ColumnRef("k")))),))
    node = AggNode(op, op.output_relation([rel], registry), 0)
    node.set_input_relation(rel, registry)
    node._device = torch.device("meta")  # any engine device but the CPU
    node._reset_window()
    node._ensure_capacity(4 * node._capacity)  # growth
    st = node._states["model"]
    assert all(v.device.type == "cpu" for v in st.values())
    merged = uda.merge(st, uda.init(st["count"].shape[0], "cpu"))
    assert all(v.device.type == "cpu" for v in merged.values())


def test_kmeans_predict_through_pxl_matches_reference():
    model = json.dumps({"k": 2, "centers": [[0.0, 0.0], [10.0, -5.0]]})
    query = ("df = px.DataFrame(table='events')\n"
             f"df.cluster = px.kmeans_predict(df.emb, '{model}')\n"
             "s = df.groupby(['cluster']).agg(n=('time_', px.count))\n"
             "px.display(s, 'out')\n")
    port, cl = _ml_events("port", 200)
    got = port.execute_query(query).table("out")
    want = _ml_events("ref", 200)[0].execute_query(query).table("out")
    assert got == want
    assert dict(zip(got["cluster"], got["n"])) == {0: int((cl == 0).sum()), 1: int((cl == 1).sum())}


def test_kmeans_predict_malformed_inputs():
    from pixie_tpu_torch.udf.builtins import ml_ops

    from pixie_tpu.udf.registry import default_registry as ref_registry

    ref_fn = ref_registry().lookup_scalar("kmeans_predict", [RefDT.STRING, RefDT.STRING]).fn
    embs = np.array(["[0.1, 0.2]", "not json", "[]", "[9.5, -4.0, 3.0]"], dtype=object)
    for model in ('{"k":2,"centers":[[0,0],[10,-5]]}', "nope", '{"k":0,"centers":[]}'):
        got = ml_ops.kmeans_predict(embs, np.array([model], dtype=object))
        want = ref_fn(embs, np.array([model], dtype=object))
        np.testing.assert_array_equal(got, want)


def test_ml_names_are_ported():
    for name in ("reservoir_sample", "kmeans", "kmeans_predict", "sentencepiece", "transformer"):
        assert name not in NOT_PORTED
