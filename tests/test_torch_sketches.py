"""Parity of the port's sketches (plain PyTorch versions of H5-H10 and the
count-min path) with pixie_tpu.ops.{hll,countmin,tdigest} on the CPU.

Held exactly: HLL registers and their rounded estimates, count-min cells and
totals, t-digest weights (integer counts), the count-min JSON letter for
letter. HLL estimates before rounding within a relative 1e-12. t-digest
means within the reference's own f32 summation error: per block, a
cluster's sum of w rows may be off by (w + 2) * 2^-24 * max|v|, so after B
blocks |port - ref| <= B * (w + 2) * 2^-24 * max|v|. Quantiles of one
state within a relative 1e-6 (a few f32 ulps), also at H9's edge digests
(``ops/quantile_edges.py``: empty, one centroid, empties between full
ones, all weight in the last, totals of 2^24 and above, fractional
weights, capacities other than 256, 40 qs), but for the groups whose
cumulative weights round (a total above 2^24, fractional weights): the
reference and the plain version sum them in their own orders, so those
agree within ``quantile_edges.td_inexact_tol`` (value by value: the range
of the reference's interpolation over the targets that the two orders'
rounding can reach, plus 4 f32 ulps). A
model of H9's warp (lanes of 8 centroids, chunks of 256, integer sums where
the weights are whole and total at most 2^24, a lower bound over the
running maximum of the non-empty midpoints) returns the plain version's
bits on such groups and agrees within that bound on the others.

The t-digest's cluster ids follow the Fault-4 contract (PERF.md): the
reference's f32 arcsin (XLA-CPU) and the plain version's (the f64 asin
rounded to f32) may give a cluster id one apart, and only where the f64
coordinate k(q) * capacity lies within 1e-4 of an integer.

The reference runs under both sorted strategies (HLL, count-min: the
sort-compact lane and the scatter lane) and both segment strategies
(t-digest: the one-hot matmul lane and the scatter lane).
"""

import json
import math
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.ops import countmin as ref_cm
from pixie_tpu.ops import hll as ref_hll
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.ops import tdigest as ref_td
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu.types import DataType as RefDT
from pixie_tpu_torch import interop
from pixie_tpu_torch.ops import countmin, hll, kernels, tdigest
from pixie_tpu_torch.ops.quantile_edges import (
    QS_WIDE, TD_CAPACITIES, TD_EDGE_GROUPS, td_edge_state, td_inexact_tol,
)
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import default_registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

N = 30_000
QS = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)
EPS_F4 = 1e-4  # the Fault-4 contract's distance to an integer coordinate


@pytest.fixture(params=[True, False], ids=["sorted_compact", "scatter"])
def sorted_lane(request):
    ref_segment.set_sorted_strategy(request.param)
    yield request.param
    ref_segment.set_sorted_strategy(None)


@pytest.fixture(params=["matmul", "scatter"])
def strategy(request):
    ref_segment.set_strategy(request.param)
    yield request.param
    ref_segment.set_strategy(None)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rows(seed: int, G: int, kind: str):
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, G, N).astype(np.int32)
    mask = rng.random(N) < 0.85
    if kind == "int64":
        vals = rng.integers(-(1 << 40), 1 << 40, N, dtype=np.int64)
        vals[: N // 2] = rng.integers(1024, 65535, N // 2)  # remote_port-like
    elif kind == "status":
        vals = rng.choice(np.array([200, 301, 404, 500], np.int64), N, p=[0.85, 0.05, 0.05, 0.05])
    else:
        vals = rng.normal(0.0, 1e6, N)
        vals[:4] = [0.0, -0.0, np.inf, 1e-310]
    return gids, mask, vals


# ---------------------------------------------------------------- HLL
@pytest.mark.parametrize("G", [16, 300])
@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_hll_registers_exact(sorted_lane, G, kind):
    gids, mask, vals = _rows(1, G, kind)
    want = ref_hll.init(G)
    got = hll.init(G, "cpu")
    for sl in (slice(0, N // 2), slice(N // 2, N)):  # two blocks
        want = ref_hll.update(want, jnp.asarray(gids[sl]), jnp.asarray(vals[sl]),
                              jnp.asarray(mask[sl]))
        got = hll.update(got, _t(gids[sl]), _t(vals[sl]), _t(mask[sl]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # merge, estimate (relative 1e-12 before rounding) and the rounded estimate
    other = ref_hll.update(ref_hll.init(G), jnp.asarray(gids), jnp.asarray(vals[::-1].copy()))
    merged_w = np.asarray(ref_hll.merge(want, other))
    merged_g = hll.merge(got, _t(np.asarray(other))).numpy()
    np.testing.assert_array_equal(merged_g, merged_w)
    est_w = np.asarray(ref_hll.estimate(jnp.asarray(merged_w)))
    est_g = hll.estimate(_t(merged_w)).numpy()
    np.testing.assert_allclose(est_g, est_w, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(
        hll.estimate_rounded(_t(merged_w)).numpy(), np.round(est_w).astype(np.int64)
    )


def test_hll_estimate_ranges():
    """Linear counting (many zero registers), the raw estimate, and the 2^32
    large-range correction (registers near their maximum)."""
    rng = np.random.default_rng(2)
    state = np.zeros((4, 2048), np.int32)
    state[1, :100] = 3  # mostly zeros: linear counting
    state[2] = rng.integers(8, 14, 2048)  # raw
    state[3] = rng.integers(20, 23, 2048)  # > 2^32 / 30: large range
    want = np.asarray(ref_hll.estimate(jnp.asarray(state)))
    got = hll.estimate(_t(state)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert want[3] > 2**32 / 30


def _h10_states(p: int, seed: int) -> np.ndarray:
    """Registers in [0, 33 - p], as every update keeps them: all zero, all
    at the top, uniform, geometric ranks (a sketch's shape), mostly zero
    (linear counting) and high (the large-range correction at p = 11)."""
    rng = np.random.default_rng(seed)
    m, top = 1 << p, 33 - p
    state = np.zeros((6, m), np.int32)
    state[1] = top
    state[2] = rng.integers(0, top + 1, m)
    state[3] = np.minimum(rng.geometric(0.5, m), top)
    state[4, : m // 16] = rng.integers(1, top + 1, m // 16)
    state[5] = rng.integers(max(top - 3, 0), top + 1, m)
    return state


def _h10_model(state: np.ndarray) -> np.ndarray:
    """H10's sum of 2^-r a group as the kernel forms it: lane l of a warp
    takes the 16-byte chunks l, l + 32, ... of the group's registers and adds
    2^(top - r) into a uint64 (top = 33 - p); five xor-shuffle rounds add
    the lanes; the sum scaled by 2^-top. A group holding a register outside
    [0, top] adds 2^-r in f64 instead, each lane its chunks' registers in
    order, then the same rounds."""
    S, m = state.shape
    top = 33 - (m.bit_length() - 1)
    out = np.empty(S)
    for g in range(S):
        regs = state[g]
        if np.all((regs >= 0) & (regs <= top)):
            terms = np.left_shift(np.uint64(1), (top - regs).astype(np.uint64))
            chunks = terms.reshape(-1, 4).sum(axis=1, dtype=np.uint64)
            lanes = np.array([chunks[l::32].sum(dtype=np.uint64) for l in range(32)])
            dtype_sum, scale = np.uint64, True
        else:
            lanes = np.zeros(32)
            chunks = regs.reshape(-1, 4)
            for l in range(32):
                for r in chunks[l::32].reshape(-1):
                    lanes[l] += np.ldexp(1.0, -int(np.clip(r, -1100, 1100)))
            dtype_sum, scale = np.float64, False
        w = 16
        while w >= 1:
            lanes = (lanes + lanes[np.arange(32) ^ w]).astype(dtype_sum)
            w //= 2
        out[g] = np.ldexp(float(lanes[0]), -top) if scale else lanes[0]
    return out


@pytest.mark.parametrize("p", [4, 11, 14])
def test_hll_estimate_integer_sum_is_exact(p):
    """H10's integer sum: over registers in [0, 33 - p], sum 2^(33 - p - r)
    times 2^-(33 - p) equals torch.sum(torch.pow(2.0, -regs)) bit for bit
    (every partial sum is a multiple of 2^-(33 - p) below 2^34 of them), and
    so does the kernel's order (``_h10_model``); the plain estimate matches
    the reference's on the same state (bit for bit where it takes the raw
    estimate, alpha m^2 over the sum in one division; within 1e-12 where it
    takes a log), its rounded estimates equal."""
    state = _h10_states(p, 30 + p)
    top = 33 - p
    isum = np.left_shift(np.uint64(1), (top - state).astype(np.uint64)).sum(axis=1,
                                                                            dtype=np.uint64)
    exact = torch.from_numpy(np.ldexp(isum.astype(np.float64), -top))
    want = torch.sum(torch.pow(2.0, -_t(state).to(torch.float64)), dim=1)
    assert torch.equal(exact.view(torch.int64), want.view(torch.int64))
    model = torch.from_numpy(_h10_model(state))
    assert torch.equal(model.view(torch.int64), want.view(torch.int64))
    est = hll.estimate_plain(_t(state)).numpy()
    ref = np.asarray(ref_hll.estimate(jnp.asarray(state)))
    np.testing.assert_allclose(est, ref, rtol=1e-12, atol=0)
    m = 1 << p
    raw = hll._alpha(m) * m * m / want.numpy()
    takes_raw = ~((raw <= 2.5 * m) & (state == 0).any(axis=1)) & (raw <= 2.0**32 / 30)
    assert takes_raw.any()
    np.testing.assert_array_equal(est[takes_raw].view(np.int64), ref[takes_raw].view(np.int64))
    np.testing.assert_array_equal(
        hll.estimate_rounded(_t(state)).numpy(), np.round(ref).astype(np.int64))


def test_hll_estimate_out_of_range_register_takes_f64_terms():
    """A register outside [0, 33 - p] (no path makes one: above the top,
    and negative) sends its group down H10's f64 lane: the model's sum of
    2^-r in the kernel's order is within a relative 1e-12 of the plain
    version's, and the other groups stay bit for bit."""
    state = _h10_states(11, 41)
    state[2, 5] = 33 - 11 + 4
    state[3, 700] = -2
    want = torch.sum(torch.pow(2.0, -_t(state).to(torch.float64)), dim=1).numpy()
    got = _h10_model(state)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    keep = [0, 1, 4, 5]
    assert np.array_equal(got[keep].view(np.int64), want[keep].view(np.int64))


# ---------------------------------------------------------------- count-min
@pytest.mark.parametrize("kind", ["status", "int64"])
def test_countmin_cells_and_totals_exact(sorted_lane, kind):
    G = 16
    gids, mask, vals = _rows(3, G, kind)
    want = ref_cm.init(G)
    cm, total = countmin.init(G, "cpu"), torch.zeros(G, dtype=torch.int64)
    for sl in (slice(0, N // 3), slice(N // 3, N)):
        want = ref_cm.update(want, jnp.asarray(gids[sl]), jnp.asarray(vals[sl]),
                             jnp.asarray(mask[sl]))
        cm, total = countmin.update_counted(cm, total, _t(gids[sl]), _t(vals[sl]), _t(mask[sl]))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        total.numpy(), np.bincount(gids[mask], minlength=G).astype(np.int64)
    )
    # update() (the sketch alone) and query() against the reference
    alone = countmin.update(countmin.init(G, "cpu"), _t(gids), _t(vals), _t(mask))
    want_all = ref_cm.update(ref_cm.init(G), jnp.asarray(gids), jnp.asarray(vals),
                             jnp.asarray(mask))
    np.testing.assert_array_equal(alone.numpy(), np.asarray(want_all))
    np.testing.assert_array_equal(
        countmin.query(alone, _t(gids[:500]), _t(vals[:500])).numpy(),
        np.asarray(ref_cm.query(want_all, jnp.asarray(gids[:500]), jnp.asarray(vals[:500]))),
    )


def test_countmin_query_takes_every_depth_row():
    """H30's plain version against the reference's query where each depth
    row in turn holds a query's smallest cell: the min reaches every row,
    and the estimates are the reference's exactly."""
    G, depth, width = 3, 4, 8192
    rng = np.random.default_rng(31)
    n = 4000
    gids = rng.integers(0, G, n).astype(np.int32)
    vals = rng.integers(-(2**40), 2**40, n)
    state = rng.integers(1000, 2000, (G, depth, width)).astype(np.int64)
    cells = [b.numpy() for b in countmin._buckets(_t(vals), depth, width)]
    for i in range(n):  # query i's cell in row i % depth is its smallest
        d = i % depth
        state[gids[i], d, cells[d][i]] = rng.integers(0, 1000)
    got = countmin.query(_t(state), _t(gids), _t(vals)).numpy()
    want = np.asarray(ref_cm.query(jnp.asarray(state), jnp.asarray(gids), jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)
    per_row = np.stack([state[gids, d, cells[d]] for d in range(depth)])
    assert set(np.argmin(per_row, axis=0).tolist()) == set(range(depth))
    np.testing.assert_array_equal(got, per_row.min(axis=0))


def test_countmin_uda_json_letter_for_letter():
    """The count_min UDA (update, merge, device finalize, format) against the
    reference UDA's finalize, as strings."""
    G = 16
    gids, mask, vals = _rows(4, G, "status")
    ref_uda = ref_registry().lookup_uda("count_min", [RefDT.INT64])
    uda = default_registry().lookup_uda("count_min", [DataType.INT64])
    half = N // 2
    ra = ref_uda.update(ref_uda.init(G), jnp.asarray(gids[:half]), jnp.asarray(vals[:half]),
                        jnp.asarray(mask[:half]))
    rb = ref_uda.update(ref_uda.init(G), jnp.asarray(gids[half:]), jnp.asarray(vals[half:]),
                        jnp.asarray(mask[half:]))
    pa = uda.update(uda.init(G, "cpu"), _t(gids[:half]), _t(vals[:half]), _t(mask[:half]))
    pb = uda.update(uda.init(G, "cpu"), _t(gids[half:]), _t(vals[half:]), _t(mask[half:]))
    want = ref_uda.finalize(ref_uda.merge(ra, rb))
    merged = uda.merge(pa, pb)
    assert list(uda.format_output(uda.device_finalize(merged).numpy())) == list(want)
    assert list(uda.finalize(merged)) == list(want)
    # state interop: the reference's dict state, through the port, back
    st = interop.state_from_numpy(uda, {k: np.asarray(v) for k, v in ra.items()})
    assert st["cm"].dtype == torch.int64 and st["total"].dtype == torch.int64
    back = interop.state_to_numpy(uda, st)
    for k in ("cm", "total"):
        np.testing.assert_array_equal(back[k], np.asarray(ra[k]))


# ---------------------------------------------------------------- t-digest
def _td_blocks(G: int, seed: int, blocks: int = 3):
    rng = np.random.default_rng(seed)
    n = blocks * 8_000
    gids = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    v = rng.exponential(3e7, n)
    v[:3] = [0.0, -0.0, 1.0]
    edges = np.linspace(0, n, blocks + 1).astype(int)
    return [(gids[a:b], mask[a:b], v[a:b]) for a, b in zip(edges[:-1], edges[1:])]


def _assert_digest_close(got: dict, want: dict, vmax: float, n_blocks: int) -> None:
    gw, ww = got["weights"].numpy(), np.asarray(want["weights"])
    np.testing.assert_array_equal(gw, ww)
    bound = n_blocks * (ww.astype(np.float64) + 2) * 2.0**-24 * vmax
    err = np.abs(got["means"].numpy().astype(np.float64) - np.asarray(want["means"]))
    assert np.all(err <= bound), float((err - bound).max())


@pytest.mark.parametrize(
    "lane, G",
    [("matmul", 16), ("scatter", 16), ("scatter", 300)],
    ids=["packed-matmul", "packed-scatter", "two_key-scatter"],
)
def test_tdigest_update_and_quantiles(lane, G):
    """The packed path (G = 16) under both reference lanes; the two-key path
    (G = 300) under the scatter lane, the one the reference takes there
    (G * 256 segments are above its matmul limit of 8192)."""
    ref_segment.set_strategy(lane)
    try:
        _check_tdigest_update(G)
    finally:
        ref_segment.set_strategy(None)


def _check_tdigest_update(G: int) -> None:
    blocks = _td_blocks(G, seed=G)
    want = ref_td.init(G)
    got = tdigest.init(G, "cpu")
    for gids, mask, v in blocks:
        want = ref_td.update(want, jnp.asarray(gids), jnp.asarray(v), jnp.asarray(mask))
        got = tdigest.update(got, _t(gids), _t(v), _t(mask))
    vmax = max(float(np.abs(v.astype(np.float32)).max()) for _, _, v in blocks)
    _assert_digest_close(got, want, vmax, len(blocks))
    # quantiles of one state, within a few f32 ulps; empty groups give 0
    same = {k: _t(np.asarray(a)) for k, a in want.items()}
    qw = np.asarray(ref_td.quantile_values(want, QS))
    qg = tdigest.quantile_values(same, QS).numpy()
    np.testing.assert_allclose(qg, qw, rtol=1e-6, atol=0)


def test_tdigest_packed_sort_matches_reference():
    """The sorted (group, value) rows of the packed path (values rebuilt
    from the key, low bits dropped) are the reference's, bit for bit."""
    G = 16
    gids, mask, v = _td_blocks(G, seed=9, blocks=1)[0]
    bits_g = (G + 1).bit_length()
    v32 = v.astype(np.float32)
    g_ref = np.where(mask, gids, G).astype(np.int32)
    wg, wv = ref_td._packed_sort(jnp.asarray(gids), jnp.asarray(v32), jnp.asarray(mask), G, bits_g)
    gg, gv = tdigest._sorted_rows(_t(gids), _t(v32), _t(mask), G)
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(gv.numpy().view(np.int32), np.asarray(wv).view(np.int32))
    assert (np.asarray(wg) == G).sum() == (g_ref == G).sum()


# H7, the sort-free block update (ops/kernels/tdigest_kernels.cu), modelled
# step by step in torch: (a) the packed keys and each group's level-1
# counts, (b) the run starts from the counts alone, (c) the key at each run
# start selected by two more histogram levels, with its lt and eq, (d) the
# runs' weights and ties, and every other row added to the run of the
# largest selected key below it. Held against the plain version's sums over
# the sorted rows (``_cluster_sums_plain(_sorted_rows(...))``): the weights
# and each cell's multiset of values (value bits, multiplicity) bit for bit,
# the f64 value sums within 1e-12 * sum |v|.
from test_torch_kernels import TD_UPDATE_CASES, assert_h8_means, td_update_inputs  # noqa: E402
from pixie_tpu_torch.ops.tdigest_edges import H8_CASES, h8_inputs  # noqa: E402


def _h7_model(gids, v32, mask, G: int, C: int) -> dict:
    b1, b2, b3 = kernels.td_levels(G)
    bits_g = (G + 1).bit_length()
    W = 32 - bits_g
    B1, B2, B3 = 1 << b1, 1 << b2, 1 << b3
    i64 = torch.int64
    # (a) pack; level-1 counts a group, scanned
    ok = (gids >= 0) & (gids < G) & mask
    g = torch.where(ok, gids.to(i64), G)
    u = tdigest._order_key(v32) >> bits_g
    bin1 = u >> (W - b1)
    hist1 = torch.zeros(G * B1, dtype=i64).index_add_(0, (g * B1 + bin1)[ok],
                                                       torch.ones(int(ok.sum()), dtype=i64))
    hist1 = hist1.view(G, B1)
    n_g = hist1.sum(dim=1)
    cum1 = torch.cumsum(hist1, dim=1) - hist1
    # (b) the cluster at every rank of every group; the ranks where it changes
    rg, rr, rc = [], [], []
    for gg in range(G):
        n = int(n_g[gg])
        if n == 0:
            continue
        q = (torch.arange(n).to(torch.int32).to(torch.float32) + 0.5) / float(n)
        cl = tdigest._cluster_ids(q, C)
        start = torch.ones(n, dtype=torch.bool)
        start[1:] = cl[1:] != cl[:-1]
        r = torch.nonzero(start)[:, 0]
        assert r.numel() <= C  # the kernel traps past C runs a group
        rg.append(torch.full_like(r, gg))
        rr.append(r)
        rc.append(cl[r].to(i64))
    rg, rr, rc = torch.cat(rg), torch.cat(rr), torch.cat(rc)
    rb1 = torch.searchsorted(cum1[rg], rr[:, None], right=True)[:, 0] - 1
    t = rr - cum1[rg, rb1]
    lt = cum1[rg, rb1].clone()
    # (c) level 2, then level 3: a histogram over the rows of the bins that
    # hold a run start, the run start's bin in it by its rank
    act1, slot1 = torch.unique(rg * B1 + rb1, return_inverse=True)
    map1 = torch.zeros(G * B1, dtype=i64)
    map1[act1] = torch.arange(1, act1.numel() + 1)
    s = map1[g.clamp_max(G - 1) * B1 + bin1] * ok
    in2 = s > 0
    hist2 = torch.zeros(act1.numel() * B2, dtype=i64).index_add_(
        0, ((s - 1) * B2 + ((u >> b3) & (B2 - 1)))[in2], torch.ones(int(in2.sum()), dtype=i64))
    inc2 = torch.cumsum(hist2.view(-1, B2), dim=1)[slot1]
    rb2 = torch.searchsorted(inc2, t[:, None], right=True)[:, 0]
    below = inc2.gather(1, rb2[:, None])[:, 0] - hist2.view(-1, B2)[slot1, rb2]
    t, lt = t - below, lt + below
    act2, slot2 = torch.unique(slot1 * B2 + rb2, return_inverse=True)
    map2 = torch.zeros(act1.numel() * B2, dtype=i64)
    map2[act2] = torch.arange(1, act2.numel() + 1)
    s2 = torch.where(in2, map2[((s - 1) * B2 + ((u >> b3) & (B2 - 1))).clamp_min(0)], 0)
    in3 = s2 > 0
    hist3 = torch.zeros(act2.numel() * B3, dtype=i64).index_add_(
        0, ((s2 - 1) * B3 + (u & (B3 - 1)))[in3], torch.ones(int(in3.sum()), dtype=i64))
    inc3 = torch.cumsum(hist3.view(-1, B3), dim=1)[slot2]
    rb3 = torch.searchsorted(inc3, t[:, None], right=True)[:, 0]
    eq = hist3.view(-1, B3)[slot2, rb3]
    lt = lt + inc3.gather(1, rb3[:, None])[:, 0] - eq
    key = (rb1 << (W - b1)) | (rb2 << b3) | rb3
    # (d) runs in rank order: weights, ties; the other rows
    order = torch.argsort(rg * (1 << 32) + rr)
    rg, rr, rc, key, lt, eq = (x[order] for x in (rg, rr, rc, key, lt, eq))
    last = torch.ones_like(rg, dtype=torch.bool)
    last[:-1] = rg[1:] != rg[:-1]
    nxt = torch.where(last, n_g[rg], torch.roll(rr, -1))
    cell = rg * C + rc
    weights = torch.zeros(G * C, dtype=torch.float64).index_add_(0, cell, (nxt - rr).double())
    x_of = lambda k: tdigest._from_order_key((k << bits_g) & tdigest.M32)  # noqa: E731
    terms = []  # (cell, key, m)
    for k2, lt2, eq2, use in ((key, lt, eq, torch.ones_like(last)),
                              (torch.roll(key, -1), torch.roll(lt, -1), torch.roll(eq, -1),
                               ~last & (torch.roll(key, -1) != key))):
        m = torch.clamp_min(torch.minimum(nxt, lt2 + eq2) - torch.maximum(rr, lt2), 0) * use
        terms.append((cell[m > 0], k2[m > 0], m[m > 0]))
    flat_k = rg * (1 << W) + key
    row_k = g * (1 << W) + u
    p = torch.searchsorted(flat_k, row_k)
    tie = (p < flat_k.numel()) & (flat_k[p.clamp_max(flat_k.numel() - 1)] == row_k)
    other = ok & ~tie
    row_cell = cell[(p - 1).clamp_min(0)]
    values = torch.zeros(G * C, dtype=torch.float64).index_add_(
        0, row_cell[other], x_of(u[other]).double())
    multiset = {}
    for c, k, m in [(row_cell[other], u[other], torch.ones(int(other.sum()), dtype=i64))] + terms:
        for ci, ki, mi in zip(c.tolist(), x_of(k).view(torch.int32).tolist(), m.tolist()):
            multiset[ci, ki] = multiset.get((ci, ki), 0) + mi
    for c, k, m in terms:
        values.index_add_(0, c, m.double() * x_of(k).double())
    return {"weights": weights.view(G, C), "values": values.view(G, C), "multiset": multiset}


@pytest.mark.parametrize("case,G", TD_UPDATE_CASES)
def test_tdigest_update_model_matches_plain(case, G):
    gids, vals, mask = td_update_inputs(case, G)
    C = tdigest.DEFAULT_CAPACITY
    g, v32, m = _t(gids), _t(vals.astype(np.float32)), _t(mask)
    got = _h7_model(g, v32, m, G, C)
    g_s, v_s = tdigest._sorted_rows(g, v32, m, G)
    want = tdigest._cluster_sums_plain(g_s, v_s, G, C)
    assert torch.equal(got["weights"].view(torch.int64), want[0].view(torch.int64))
    flat, _ = tdigest._row_clusters(g_s, G, C)
    live = g_s < G
    plain = {}
    for ci, ki in zip(flat[live].tolist(), v_s[live].view(torch.int32).tolist()):
        plain[ci, ki] = plain.get((ci, ki), 0) + 1
    assert got["multiset"] == plain
    scale = tdigest._cluster_sums_plain(g_s, v_s.abs(), G, C)[1]
    nan = torch.isnan(want[1])
    assert torch.equal(torch.isnan(got["values"]), nan)
    fin = torch.isfinite(want[1])
    assert torch.equal(got["values"][~fin & ~nan], want[1][~fin & ~nan])
    assert bool(torch.all((got["values"] - want[1]).abs()[fin] <= 1e-12 * scale[fin]))


# H8, the merge (ops/kernels/sketch_kernels.cu), modelled step by step in
# torch: (a) each centroid's argsort key and class (finite, +inf, NaN) and
# its index in its class and among its half's finite keys; (b) its rank by
# a binary search into the other half's finite keys while both halves'
# are nondecreasing, else by all (key, index) pairs below it; (c) the
# cumulative weights by the kernel's warp scan (a Hillis-Steele scan of 32
# lanes, the warps' totals added in order); (d) the clusters of the
# midpoints (the plain version's arithmetic); (e) while the clusters are
# nondecreasing, each run's sums by the kernel's segmented warp scan and
# its carries across warps, else each cluster's sums over the sorted
# centroids. Held against merge_plain (weights bit for bit, means within
# 2C * 2^-24 * max|mean| of the group's finite inputs, NaN and inf alike)
# and against the reference's merge under the Fault-4 contract.
_INF_KEY = 0xFF800000  # sort_key(+inf)


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """sketch_kernels.cu sort_key: the order key (-0 as +0), NaN last."""
    k = tdigest._order_key(torch.where(x == 0, torch.zeros_like(x), x))
    return torch.where(torch.isnan(x), 0xFFFFFFFF, k)


def _warp_scan(x: torch.Tensor, head: Optional[torch.Tensor] = None):
    """The kernel's inclusive scan of x [G, n] (n a multiple of 32) within
    each warp of 32 lanes, f32 adds; with ``head``, segmented (a head
    restarts the sum). Returns (sums, flags: a head at or before the lane
    in its warp)."""
    G, n = x.shape
    s = x.view(G, n // 32, 32)
    f = (torch.zeros_like(s, dtype=torch.bool) if head is None else head.view(G, n // 32, 32))
    for d in (1, 2, 4, 8, 16):
        add = torch.where(f[..., d:], s[..., d:], s[..., :-d] + s[..., d:])
        s = torch.cat([s[..., :d], add], dim=-1)
        f = torch.cat([f[..., :d], f[..., d:] | f[..., :-d]], dim=-1)
    return s, f


def _h8_model(a: dict, b: dict, raw_b: bool = False) -> dict:
    G, C = a["means"].shape
    f32 = torch.float32
    if raw_b:  # b is H7's f64 (weight, value) sums
        bw = b["weights"].to(f32)
        bm = torch.where(bw > 0, b["means"].to(f32) / torch.clamp_min(bw, 1.0), 0.0)
    else:
        bm, bw = b["means"], b["weights"]
    m = torch.cat([a["means"], bm], dim=1)
    w = torch.cat([a["weights"], bw], dim=1)
    n2, n = 2 * C, -(-2 * C // 32) * 32
    # (a), (b)
    key = _sort_key(torch.where(w > 0, m, math.inf))
    kind = torch.where(key < _INF_KEY, 0, torch.where(key == _INF_KEY, 1, 2))
    idx = torch.arange(n2)
    sm = torch.zeros((G, n), dtype=f32)
    sw = torch.zeros((G, n), dtype=f32)
    branches = [0, 0]
    for g in range(G):
        k, kd = key[g], kind[g]
        fa, fb = k[:C][kd[:C] == 0], k[C:][kd[C:] == 0]
        if bool(torch.all(fa[1:] >= fa[:-1])) and bool(torch.all(fb[1:] >= fb[:-1])):
            rank = torch.zeros(n2, dtype=torch.int64)
            rank[:C][kd[:C] == 0] = torch.arange(fa.numel()) + torch.searchsorted(fb, fa)
            rank[C:][kd[C:] == 0] = torch.arange(fb.numel()) + torch.searchsorted(
                fa, fb, right=True)
            for c, before in ((1, fa.numel() + fb.numel()),
                              (2, fa.numel() + fb.numel() + int((kd == 1).sum()))):
                rank[kd == c] = before + torch.arange(int((kd == c).sum()))
        else:
            branches[0] += 1
            rank = ((k[None, :] < k[:, None])
                    | ((k[None, :] == k[:, None]) & (idx[None, :] < idx[:, None]))).sum(dim=1)
        assert torch.equal(torch.sort(rank).values, idx)
        sm[g, rank] = m[g]
        sw[g, rank] = w[g]
    # (c)
    s, _ = _warp_scan(sw)
    total = torch.zeros(G, dtype=f32)
    carry = torch.zeros((G, n // 32), dtype=f32)
    for k in range(n // 32):
        carry[:, k] = total
        total = total + s[:, k, 31]
    cum = (carry[..., None] + s).view(G, n)[:, :n2]
    sw, sm = sw[:, :n2], sm[:, :n2]
    # (d)
    q = (cum - tdigest._f32(0.5, "cpu") * sw) / torch.clamp_min(total, 1.0)[:, None]
    cl = tdigest._cluster_ids(q, C).to(torch.int64)
    # (e)
    mw = sm * sw
    ow = torch.zeros((G, C), dtype=f32)
    om = torch.zeros((G, C), dtype=f32)
    prev = torch.cat([torch.full((G, 1), -1), cl[:, :-1]], dim=1)
    pad = lambda x, v: torch.cat([x, torch.full((G, n - n2), v, dtype=x.dtype)], 1)  # noqa: E731
    sws, fl = _warp_scan(pad(sw, 0.0), pad(cl != prev, True))
    sms, _ = _warp_scan(pad(mw, 0.0), pad(cl != prev, True))
    sws, sms, fl = (x.reshape(G, n)[:, :n2] for x in (sws, sms, fl))
    nxt = torch.cat([cl[:, 1:], torch.full((G, 1), C)], dim=1)
    for g in range(G):
        if bool(torch.any(cl[g] < prev[g])):
            branches[1] += 1
            ow[g].index_add_(0, cl[g], sw[g])
            om[g].index_add_(0, cl[g], mw[g])
            continue
        for t in torch.nonzero(nxt[g] != cl[g])[:, 0].tolist():
            s_w, s_m, f = sws[g, t], sms[g, t], bool(fl[g, t])
            k = t // 32 - 1
            while not f and k >= 0:  # the run began in an earlier warp
                last = 32 * k + 31
                s_w, s_m, f = sws[g, last] + s_w, sms[g, last] + s_m, bool(fl[g, last])
                k -= 1
            ow[g, cl[g, t]], om[g, cl[g, t]] = s_w, s_m
    means = torch.where(ow > 0, om / torch.clamp_min(ow, 1e-9), 0.0)
    return {"means": means, "weights": ow, "branches": branches, "q": q, "sorted_w": sw}


@pytest.mark.parametrize("case,G", H8_CASES)
def test_tdigest_merge_model_matches_plain_and_reference(case, G):
    C = tdigest.DEFAULT_CAPACITY
    a, b, raw_b = h8_inputs(case, G, C)
    got = _h8_model(a, b, raw_b)
    bb = tdigest.batch_from_sums(b["weights"], b["means"]) if raw_b else b
    want = tdigest.merge_plain(a, bb)
    assert torch.equal(got["weights"].view(torch.int32), want["weights"].view(torch.int32))
    assert_h8_means(got["means"], want["means"], a, bb, torch.ones_like(want["means"],
                                                                            dtype=torch.bool), C)
    expect = {"inverted": [G, 0], "repeat": [0, G]}.get(case)
    if expect is not None or case != "blocks":
        assert got["branches"] == (expect or [0, 0]), got["branches"]
    # The reference's merge under the Fault-4 contract: group weights
    # exact; a cell's weight moves only by centroids whose f64 cluster
    # coordinate lies within 1e-4 of an integer; the other cells' means as
    # above.
    ref = ref_td.merge({k: jnp.asarray(v.numpy()) for k, v in a.items()},
                       {k: jnp.asarray(v.numpy()) for k, v in bb.items()})
    rw, rm = _t(np.asarray(ref["weights"])), _t(np.asarray(ref["means"]))
    assert torch.equal(rw.sum(dim=1), got["weights"].sum(dim=1))
    qc = torch.clamp(got["q"].double(), float(np.float32(1e-7)), float(np.float32(1 - 1e-7)))
    coord = (torch.asin(2 * qc - 1) / math.pi + 0.5) * C
    near = (coord - torch.round(coord)).abs() <= EPS_F4
    allow = 2 * torch.where(near, got["sorted_w"].abs(), 0.0).sum(dim=1)
    dw = (rw - got["weights"]).abs()
    assert bool(torch.all(dw.sum(dim=1) <= allow))
    assert_h8_means(got["means"], rm, a, bb, dw == 0, C)


def test_tdigest_merge_of_states(strategy):
    """merge() of two independently built digests."""
    G = 16
    a_blocks, b_blocks = _td_blocks(G, seed=21), _td_blocks(G, seed=22)
    states = []
    for blocks in (a_blocks, b_blocks):
        st = ref_td.init(G)
        for gids, mask, v in blocks:
            st = ref_td.update(st, jnp.asarray(gids), jnp.asarray(v), jnp.asarray(mask))
        states.append(st)
    want = ref_td.merge(*states)
    # The reference's dict states cross into the port through interop, as
    # the quantiles_tdigest UDA's state.
    uda = default_registry().lookup_uda("quantiles_tdigest", [DataType.FLOAT64])
    ported = [
        interop.state_from_numpy(uda, {k: np.asarray(a) for k, a in s.items()})
        for s in states
    ]
    got = uda.merge(*ported)
    vmax = max(float(np.abs(np.asarray(s["means"])).max()) for s in states)
    _assert_digest_close(got, want, vmax, 1)
    back = interop.state_to_numpy(uda, got)
    assert set(back) == {"means", "weights"} and back["means"].dtype == np.float32


def test_fault4_cluster_ids_contract():
    """Over 4M mid-quantiles (random, and every rank of counts up to 2^22),
    the plain version's cluster ids equal the reference's except where the
    f64 coordinate lies within 1e-4 of an integer, and then by one."""
    rng = np.random.default_rng(11)
    q = [rng.random(2_000_000)]
    for c in (1000, 12_345, 1 << 20, 1 << 22):
        r = np.arange(0, c, max(1, c // 500_000))
        q.append((r + 0.5) / c)
    q = np.concatenate(q).astype(np.float32)
    want = np.asarray(ref_td._cluster_ids(jnp.asarray(q), 256))
    got = tdigest._cluster_ids(_t(q), 256).numpy()
    qc = np.clip(q, np.float32(1e-7), np.float32(1 - 1e-7)).astype(np.float64)
    coord = (np.arcsin(2 * qc - 1) / math.pi + 0.5) * 256
    diff = got != want
    assert np.all(np.abs(got.astype(np.int64) - want) <= 1)
    assert np.all(np.abs(coord - np.round(coord))[diff] <= EPS_F4)
    assert diff.sum() <= 1e-4 * q.size


def test_fault4_worst_case_moves_quantiles_within_contract(monkeypatch):
    """The query-level quantile bound (relative 1e-2, PERF.md) holds even
    when EVERY cluster id whose coordinate lies within 1e-4 of an integer is
    pushed to the other side — far more often than any real arcsin does.
    config 5's query at 200k rows, 16k-row blocks."""
    from test_torch_sketch_queries import SKETCHES, http_events, run_port

    data = http_events(200_000, seed=42)
    base = run_port(data, SKETCHES, "sketches", block_rows=1 << 14)
    orig = tdigest._cluster_ids
    flips = []

    def pushed(q, capacity):
        cl = orig(q, capacity)
        qc = torch.clamp(q.double(), 1e-7, 1 - 1e-7)
        c = (torch.asin(2 * qc - 1) / math.pi + 0.5) * capacity
        near = (c - torch.round(c)).abs() < EPS_F4
        alt = torch.where(cl.double() >= torch.round(c), torch.round(c) - 1, torch.round(c))
        alt = torch.clamp(alt.to(torch.int32), 0, capacity - 1)
        flips.append(int((near & (alt != cl)).sum()))
        return torch.where(near, alt, cl)

    monkeypatch.setattr(tdigest, "_cluster_ids", pushed)
    moved = run_port(data, SKETCHES, "sketches", block_rows=1 << 14)
    assert sum(flips) > 50
    rel = []
    for a, b in zip(base["lat"], moved["lat"]):
        a, b = json.loads(a), json.loads(b)
        rel += [abs(a[k] - b[k]) / abs(a[k]) for k in a]
    assert max(rel) <= 1e-2, max(rel)


# ---------------------------------------------------------------- H5 inputs
# H5 hashes a column where the fold staged it: a narrowed int64 column
# (uint8, uint16 or int32 with its frame-of-reference offset) as its int64
# value v + off, an unnarrowed int32 column as words64's u32, an f64 column
# as its bits. The plain path widens (segment.Narrow); both must give the
# reference's registers over the widened column.
_NARROW_CASES = {
    "uint8+off": ("uint8", 1 << 40),
    "uint16+off": ("uint16", 1024),
    "int32+off": ("int32", -(1 << 35)),
    "int64+off": ("int64", np.iinfo(np.int64).max - 50),
    "int32": ("int32", None),
    "float64": ("float64", None),
}


def _narrow_column(rng, case: str):
    """(staged values, offset or None, the column the reference sees)."""
    dt, off = _NARROW_CASES[case]
    if dt == "float64":
        v = rng.normal(0.0, 1e6, N)
        v[:3] = [0.0, -0.0, np.inf]
        return v, None, v
    if dt == "int32" and off is None:
        v = rng.integers(-(2**31), 2**31 - 1, N).astype(np.int32)
        return v, None, v
    hi = min(int(np.iinfo(dt).max), (1 << 31) - 1)
    v = rng.integers(0, hi + 1, N).astype(dt)
    wide = (v.astype(np.int64).view(np.uint64) + np.uint64(off % (1 << 64))).view(np.int64)
    return v, off, wide


@pytest.mark.parametrize("case", list(_NARROW_CASES))
def test_hll_narrow_input_matches_reference(sorted_lane, case):
    from pixie_tpu_torch.ops import segment

    rng = np.random.default_rng(21)
    G = 300
    gids = rng.integers(0, G, N).astype(np.int32)
    mask = rng.random(N) < 0.85
    v, off, ref_col = _narrow_column(rng, case)
    want = ref_hll.update(ref_hll.init(G), jnp.asarray(gids), jnp.asarray(ref_col),
                          jnp.asarray(mask))
    col = _t(v) if off is None else segment.Narrow(_t(v), off)
    got = hll.update(hll.init(G, "cpu"), _t(gids), col, _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _kind_words(v: np.ndarray, kind: int, off) -> np.ndarray:
    """H5's word of each row from its staged bytes and row kind (rows.cuh
    load_vals8, then + off), as int64."""
    from pixie_tpu_torch.ops import kernels

    if kind == kernels.ROW_F64:
        raw = v.astype(np.float64).view(np.uint64)
    elif kind == kernels.ROW_U32:
        raw = v.view(np.uint32).astype(np.uint64)
    elif kind == kernels.ROW_I32:
        raw = v.astype(np.int64).view(np.uint64)
    else:  # u8, u16 zero-extend; i64 as it is
        raw = v.astype(np.uint64) if v.dtype != np.int64 else v.view(np.uint64)
    return (raw + np.uint64((off or 0) % (1 << 64))).view(np.int64)


@pytest.mark.parametrize("case", list(_NARROW_CASES) + ["bool"])
def test_hll_word_kind_gives_words64(case):
    """The row kind H5 and H6 read each staged dtype as, applied to its
    bytes, gives the word the plain path hashes: hashing.words64 of the
    column the fold would have widened."""
    from pixie_tpu_torch.ops import hashing, kernels, segment

    rng = np.random.default_rng(22)
    if case == "bool":
        v, off = rng.random(N) < 0.5, None
    else:
        v, off, _ = _narrow_column(rng, case)
    kind = kernels.word_kind(_t(v).dtype, off)
    col = _t(v) if off is None else segment.Narrow(_t(v), off)
    want = hashing.words64(segment.widen(col)).numpy()
    np.testing.assert_array_equal(_kind_words(v, kind, off), want)
    with pytest.raises(ValueError):
        kernels.word_kind(torch.float64, 3)


# ---------------------------------------------------------------- H6 inputs
# H6 hashes its words in the kernel from the column as staged, as H5 does: a
# narrowed INT64 column (uint8, uint16 or int32 with its offset) as v + off,
# an int64 column (the arghash lane's content words of a STRING column) as
# it is. The plain path widens; both must give the reference's cells, and
# the totals must count every valid row.
@pytest.mark.parametrize("case", list(_NARROW_CASES) + ["arghash"])
def test_countmin_narrow_input_matches_reference(sorted_lane, case):
    from pixie_tpu_torch.ops import segment
    from pixie_tpu_torch.table.column import fnv1a64_batch

    rng = np.random.default_rng(23)
    G = 34  # endpoint_load's endpoints
    gids = rng.integers(-1, G + 1, N).astype(np.int32)
    mask = rng.random(N) < 0.9
    if case == "arghash":
        paths = [f"/api/v1/res-{r}/{i}" for r in range(32) for i in range(128)]
        words = fnv1a64_batch(paths + ["/healthz", "/readyz"]).view(np.int64)
        v = off = None
        ref_col = words[rng.integers(0, len(words), N)]
        col = _t(ref_col)
    else:
        v, off, ref_col = _narrow_column(rng, case)
        col = _t(v) if off is None else segment.Narrow(_t(v), off)
    ok = (gids >= 0) & (gids < G)
    want = ref_cm.update(ref_cm.init(G), jnp.asarray(np.where(ok, gids, 0)),
                         jnp.asarray(ref_col), jnp.asarray(mask & ok))
    cm, total = countmin.update_counted(
        countmin.init(G, "cpu"), torch.zeros(G, dtype=torch.int64), _t(gids), col, _t(mask)
    )
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        total.numpy(), np.bincount(gids[mask & ok], minlength=G))
    assert int(cm.numpy().sum()) == countmin.DEFAULT_DEPTH * int((mask & ok).sum())


def test_countmin_uda_takes_narrowed_int64_only():
    """count_min(INT64) takes a narrowed column as staged (``narrow_args``);
    the STRING overload keeps its arghash int64 words."""
    reg = default_registry()
    assert reg.lookup_uda("count_min", [DataType.INT64]).narrow_args
    assert not reg.lookup_uda("count_min", [DataType.STRING]).narrow_args


# ---------------------------------------------------------------- H5 edges
M32 = 0xFFFFFFFF


def _inv_mix32(h: np.ndarray, seed: int) -> np.ndarray:
    """The inverse of hashing.mix32 (murmur3's fmix32 is a bijection)."""
    x = h.astype(np.uint64) & M32
    x ^= x >> 16
    x = (x * pow(0xC2B2AE35, -1, 1 << 32)) & M32
    x ^= (x >> 13) ^ (x >> 26)
    x = (x * pow(0x85EBCA6B, -1, 1 << 32)) & M32
    x ^= x >> 16
    return x ^ np.uint64(seed & M32)


def _words_hashing_to(h: np.ndarray) -> np.ndarray:
    """int64 words below 2^32 whose hash32 (seed 0) is ``h``."""
    from pixie_tpu_torch.ops import hashing

    inner = int(hashing.mix32(torch.tensor([0]), 0x9E3779B9)[0])
    return (_inv_mix32(h, 0x85EBCA77) ^ np.uint64(inner)).astype(np.int64)


_GRID = [(G, p) for G in (1, 16, 17, 4096) for p in (4, 11, 16) if (G, p) != (4096, 16)]


@pytest.mark.parametrize("G,p", _GRID)
def test_hll_update_edges_match_reference(G, p):
    """Rows over two and a half of H5's 8192-row vectors' worth of chunks:
    some gids out of range, some rows masked, rows whose hash rests are
    zero (rho at its cap 33 - p), on a state already holding registers;
    the update (its plain version) against the reference."""
    rng = np.random.default_rng(G * 100 + p)
    n = 2 * 8192 + 4096
    gids = rng.integers(-2, G + 2, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    words = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    m = 1 << p
    capped = rng.integers(0, m, 64).astype(np.uint64) << np.uint64(32 - p)
    words[:64] = _words_hashing_to(capped)
    gids[:64] = rng.integers(0, G, 64)
    mask[:64] = True
    state = rng.integers(0, 4, (G, m)).astype(np.int32)
    got = hll.update(_t(state), _t(gids), _t(words), _t(mask)).numpy()
    assert got[gids[0], int(capped[0] >> np.uint64(32 - p))] == 33 - p
    ok = (gids >= 0) & (gids < G)
    want = ref_hll.update(jnp.asarray(state), jnp.asarray(np.where(ok, gids, 0)),
                          jnp.asarray(words), jnp.asarray(mask & ok))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_hll_update_all_masked_keeps_state():
    rng = np.random.default_rng(5)
    G, p, n = 4096, 11, 8192 + 3
    state = rng.integers(0, 9, (G, 1 << p)).astype(np.int32)
    gids = rng.integers(0, G, n).astype(np.int32)
    words = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    got = hll.update(_t(state), _t(gids), _t(words), _t(np.zeros(n, bool))).numpy()
    np.testing.assert_array_equal(got, state)


@pytest.mark.parametrize("qs", [QS, QS_WIDE], ids=["qs7", "qs40"])
@pytest.mark.parametrize("C", TD_CAPACITIES)
def test_tdigest_quantile_plain_edges_match_reference(C, qs):
    """The plain version of H9 against the reference's quantile_values at
    the edge digests: within a relative 1e-6 where the weights are whole
    and total at most 2^24, within ``td_inexact_tol`` where the cumulative
    weights round (a total above 2^24, fractional weights)."""
    means, weights = td_edge_state(C, 14, seed=C)
    want = np.asarray(ref_td.quantile_values(
        {"means": jnp.asarray(means), "weights": jnp.asarray(weights)}, qs))
    got = tdigest.quantile_values_plain({"means": _t(means), "weights": _t(weights)}, qs).numpy()
    exact = tdigest.quantile_exact_groups(_t(weights)).numpy()
    np.testing.assert_allclose(got[exact], want[exact], rtol=1e-6, atol=0)
    tol = td_inexact_tol(_t(means)[~exact], _t(weights)[~exact], qs).numpy()
    assert np.all(np.abs(got[~exact] - want[~exact]) <= tol)
    assert not got[0].any()


def test_quantile_exact_groups_flags_the_edges():
    """Whole weights in [0, 2^24] with a total of at most 2^24 are exact
    (2^24 itself included); a total above it, a fractional weight, a
    weight above 2^24, a negative or NaN weight are not."""
    means, weights = td_edge_state(256, 12, seed=1)
    flags = tdigest.quantile_exact_groups(_t(weights))
    assert flags.tolist() == [True] * 6 + [False] * 3 + [True] * (12 - TD_EDGE_GROUPS)
    w = torch.ones((3, 4))
    w[1, 2] = -1.0
    w[2, 0] = float("nan")
    assert tdigest.quantile_exact_groups(w).tolist() == [True, False, False]


def _h9_model(means: np.ndarray, weights: np.ndarray, qs) -> np.ndarray:
    """H9 as its warp computes it, in f32 with every step rounded: chunks
    of 256 centroids, 32 lanes of 8; where every weight is whole in
    [0, 2^24] and the total at most 2^24 the cumulative weights are integer
    sums converted once, else f32 adds in centroid order; the keys, the
    running maximum of the non-empty centroids' midpoints (-inf before the
    first, NaN dropped), carried across chunks; per q a five-step lower
    bound over the lanes' last keys and the count of that lane's keys below
    the target, else the count of non-empty centroids less one; the
    interpolation of quantile_values."""
    f = np.float32
    G, C = weights.shape
    pad = -(-C // 256) * 256
    out = np.zeros((G, len(qs)))
    for g in range(G):
        w = np.zeros(pad, f)
        m = np.zeros(pad, f)
        w[:C], m[:C] = weights[g], means[g]
        whole = (w >= 0) & (w <= 2**24) & (w == np.trunc(w))
        if whole.all() and w.astype(np.int64).sum() <= 2**24:
            run = np.cumsum(w.astype(np.int64)).astype(f)
        else:
            run, r = np.zeros(pad, f), f(0)
            for i in range(pad):
                r = f(r + w[i])
                run[i] = r
        cum = run - f(0.5) * w
        keys = np.fmax.accumulate(np.where(w > 0, cum, f(-np.inf))).reshape(-1, 32, 8)
        total = run[-1]
        last_valid = max(int((w > 0).sum()) - 1, 0)
        for j, q in enumerate(qs):
            target = f(f(q) * total)
            hi = last_valid
            for c in range(pad // 256):
                if not keys[c, 31, 7] >= target:
                    continue
                pos = 0
                for d in (16, 8, 4, 2, 1):
                    pos += d if keys[c, pos + d - 1, 7] < target else 0
                hi = c * 256 + pos * 8 + int((keys[c, pos] < target).sum())
                break
            lo = max(hi - 1, 0)
            c_lo, c_hi = cum[lo], cum[hi]
            frac = (target - c_lo) / max(f(c_hi - c_lo), f(1e-9)) if c_hi > c_lo else f(1)
            frac = min(max(frac, f(0)), f(1))
            v = m[hi] if hi == lo else m[lo] + frac * (m[hi] - m[lo])
            out[g, j] = float(v) if total > 0 else 0.0
    return out


@pytest.mark.parametrize("C", TD_CAPACITIES)
def test_h9_model_matches_plain(C):
    """The model of H9 returns the plain version's bits on every exact
    group of the edge digests and agrees within ``td_inexact_tol`` on the
    others, for 7 qs and 40."""
    means, weights = td_edge_state(C, 14, seed=C + 1)
    state = {"means": _t(means), "weights": _t(weights)}
    exact = tdigest.quantile_exact_groups(state["weights"]).numpy()
    for qs in (QS, QS_WIDE):
        want = tdigest.quantile_values_plain(state, qs).numpy()
        got = _h9_model(means, weights, qs)
        assert np.array_equal(got[exact].view(np.int64), want[exact].view(np.int64))
        tol = td_inexact_tol(state["means"][~exact], state["weights"][~exact], qs).numpy()
        assert np.all(np.abs(got[~exact] - want[~exact]) <= tol)
