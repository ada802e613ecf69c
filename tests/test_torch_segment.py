"""Parity of pixie_tpu_torch.ops.segment (plain PyTorch versions of kernels
H1/H2) with the reference pixie_tpu.ops.segment on the CPU.

Integer results (counts, int64 sums mod 2^64, the fused multi-row sums) must
be exactly equal. f64 sums are held to the H2 bound stated in PERF.md:
|port - ref| <= 1e-12 * sum|v| per group. The reference runs under both of
its strategies ("matmul", the TPU's one-hot lane, and "scatter").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu_torch import interop
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.udf.registry import default_registry
from pixie_tpu_torch.types import DataType

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

S = 16
N = 20_000


@pytest.fixture(params=["matmul", "scatter"])
def strategy(request):
    ref_segment.set_strategy(request.param)
    yield request.param
    ref_segment.set_strategy(None)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    gids = rng.integers(-3, S + 3, N).astype(np.int32)  # some out of range
    mask = rng.random(N) < 0.8
    ints = rng.integers(-(2**63), 2**63 - 1, N, dtype=np.int64)
    ints[:64] = np.iinfo(np.int64).max - rng.integers(0, 4, 64)  # wrap
    ints[64:128] = np.iinfo(np.int64).min + rng.integers(0, 4, 64)
    floats = rng.normal(0.0, 1e6, N)
    return gids, mask, ints, floats


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_seg_count_exact(strategy):
    gids, mask, _, _ = _inputs(1)
    want = np.asarray(ref_segment.seg_count(jnp.asarray(gids), S, jnp.asarray(mask)))
    got = segment.seg_count(_t(gids), S, _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # without a mask
    want = np.asarray(ref_segment.seg_count(jnp.asarray(gids), S))
    np.testing.assert_array_equal(segment.seg_count(_t(gids), S).numpy(), want)


def test_seg_sum_int64_wraps_exactly(strategy):
    gids, mask, ints, _ = _inputs(2)
    want = np.asarray(
        ref_segment.seg_sum(jnp.asarray(ints), jnp.asarray(gids), S, jnp.asarray(mask))
    )
    got = segment.seg_sum(_t(ints), _t(gids), S, _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_seg_sum_f64_within_bound(strategy):
    """The port is held to the H2 bound (1e-12 * sum|v| per group) against
    the exact sum (math.fsum) and against the reference's f64 scatter lane.
    The reference's matmul lane accumulates hi/lo f32 parts in chunks of
    _F64_CHUNK rows, so it differs from the exact sum by up to
    _F64_CHUNK * 2^-24 * sum|v| itself; against that lane the port is held
    to its bound plus that one."""
    import math

    gids, mask, _, floats = _inputs(3)
    want = np.asarray(
        ref_segment.seg_sum(
            jnp.asarray(floats), jnp.asarray(gids), S, jnp.asarray(mask)
        )
    )
    got = segment.seg_sum(_t(floats), _t(gids), S, _t(mask)).numpy()
    ok = mask & (gids >= 0) & (gids < S)
    abs_sum = np.bincount(gids[ok], weights=np.abs(floats[ok]), minlength=S)
    exact = np.array([math.fsum(floats[ok & (gids == g)]) for g in range(S)])
    assert np.all(np.abs(got - exact) <= 1e-12 * abs_sum)
    lane = ref_segment._F64_CHUNK * 2.0**-24 if strategy == "matmul" else 0.0
    assert np.all(np.abs(got - want) <= (1e-12 + lane) * abs_sum)


def test_fused_rows_match_limb_einsum(strategy):
    """The fused-sum lane: two int64 UDA rows and a count row plus the
    presence row, against limb_einsum_sums + reconstruct_i64 over 8-bit
    limbs."""
    gids, mask, ints, _ = _inputs(4)
    rng = np.random.default_rng(5)
    small = rng.integers(-1000, 1000, N, dtype=np.int64)
    jmask = jnp.asarray(mask)
    rows = []
    for v in (ints, small):
        rows.extend(ref_segment.limb_rows_i64(jnp.where(jmask, jnp.asarray(v), 0)))
    rows.append(jmask.astype(jnp.float32))  # count
    rows.append(jmask.astype(jnp.float32))  # presence
    totals = ref_segment.limb_einsum_sums(rows, jnp.asarray(gids), S)
    want = [
        np.asarray(ref_segment.reconstruct_i64(totals[0:8])),
        np.asarray(ref_segment.reconstruct_i64(totals[8:16])),
        np.asarray(totals[16]).astype(np.int64),
        np.asarray(totals[17]).astype(np.int64),
    ]
    got = segment.fused_segment_sums(
        [_t(ints), _t(small), _t(mask).to(torch.int64)], _t(gids), S, _t(mask)
    ).numpy()
    assert got.shape == (4, S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_seg_sum_rejects_other_dtypes():
    with pytest.raises(TypeError):
        segment.seg_sum(torch.zeros(4, dtype=torch.float32), torch.zeros(4, dtype=torch.int32), 2)


@pytest.mark.parametrize(
    "name,arg",
    [("count", DataType.INT64), ("sum", DataType.INT64), ("mean", DataType.FLOAT64)],
)
def test_uda_update_matches_reference(name, arg):
    """count/sum/mean UDA updates and finalize over the same rows, with the
    reference's state carried in through interop."""
    gids, mask, ints, floats = _inputs(6)
    gids = np.clip(gids, 0, S - 1)
    col = ints if arg == DataType.INT64 else floats
    ref_uda = ref_registry().lookup_uda(name, [arg])
    uda = default_registry().lookup_uda(name, [arg])
    ref_st = ref_uda.update(
        ref_uda.init(S), jnp.asarray(gids), jnp.asarray(col), jnp.asarray(mask)
    )
    ref_np = (
        {k: np.asarray(v) for k, v in ref_st.items()}
        if isinstance(ref_st, dict)
        else np.asarray(ref_st)
    )
    st = uda.update(uda.init(S, "cpu"), _t(gids), _t(col), mask=_t(mask))
    carried = interop.state_from_numpy(uda, ref_np)
    back = interop.state_to_numpy(uda, st)
    if isinstance(ref_np, dict):
        np.testing.assert_array_equal(back["count"], ref_np["count"])
        abs_sum = np.bincount(gids[mask], weights=np.abs(col[mask]), minlength=S)
        assert np.all(np.abs(back["sum"] - ref_np["sum"]) <= 1e-12 * abs_sum)
    else:
        np.testing.assert_array_equal(back, ref_np)
    want = np.asarray(ref_uda.finalize(ref_st))
    np.testing.assert_allclose(uda.finalize(carried).numpy(), want, rtol=1e-15)


def test_interop_rejects_wrong_state():
    uda = default_registry().lookup_uda("mean", [DataType.FLOAT64])
    with pytest.raises(ValueError):
        interop.state_from_numpy(uda, {"sum": np.zeros(2)})
    with pytest.raises(TypeError):
        interop.state_from_numpy(uda, {"sum": np.zeros(2, np.float32), "count": np.zeros(2, np.int64)})


# ---------------------------------------------------------------- typed rows
# The fused-sum lane's rows as the fold stages them (H1 reads each where it
# lies): bool, and uint8, uint16, int32, int64 columns with frame-of-
# reference offsets, some near +-2^63 so that v + off wraps; count's row as
# the presence row.
TYPED_KINDS = ("bool", "uint8", "uint16", "int32", "int64")
_OFFSETS = {
    "bool": 0,
    "uint8": np.iinfo(np.int64).max - 100,
    "uint16": np.iinfo(np.int64).min + 7,
    "int32": np.iinfo(np.int64).max - (1 << 30),
    "int64": -123_456_789,
}


def _typed_row(rng, kind: str):
    """(staged values, offset, their int64 values v + off mod 2^64)."""
    if kind == "bool":
        v = rng.random(N) < 0.5
    elif kind == "int64":
        v = rng.integers(-(2**63), 2**63 - 1, N, dtype=np.int64)
    else:
        info = np.iinfo(kind)
        v = rng.integers(0, int(info.max) + 1, N).astype(kind)
    off = int(_OFFSETS[kind])
    wide = (v.astype(np.int64).view(np.uint64) + np.uint64(off % (1 << 64))).view(np.int64)
    return v, off, wide


def _port_row(v: np.ndarray, off: int):
    t = _t(v)
    return t if off == 0 else segment.Narrow(t, off)


def _ref_fused(wides: list, gids, mask, presence: int) -> list:
    """The reference's lane: 8-bit limb rows of each int64 row, the count
    and presence rows (f32), limb_einsum_sums, reconstruct_i64; seg_count."""
    jmask = jnp.asarray(mask)
    rows = []
    for w in wides:
        rows.extend(ref_segment.limb_rows_i64(jnp.where(jmask, jnp.asarray(w), 0)))
    rows.extend([jmask.astype(jnp.float32)] * (presence + 1))
    totals = ref_segment.limb_einsum_sums(rows, jnp.asarray(gids), S)
    out = [np.asarray(ref_segment.reconstruct_i64(totals[8 * i: 8 * i + 8]))
           for i in range(len(wides))]
    out += [np.asarray(totals[8 * len(wides) + j]).astype(np.int64) for j in range(presence + 1)]
    count = np.asarray(ref_segment.seg_count(jnp.asarray(gids), S, jmask))
    np.testing.assert_array_equal(out[-1], count)
    return out


@pytest.mark.parametrize("kind", TYPED_KINDS)
def test_fused_typed_row_matches_reference(strategy, kind):
    """One staged row with its offset, count's presence row, the count."""
    gids, mask, _, _ = _inputs(6)
    v, off, wide = _typed_row(np.random.default_rng(7), kind)
    want = _ref_fused([wide], gids, mask, presence=1)
    got = segment.fused_segment_sums(
        [_port_row(v, off), segment.PRESENCE], _t(gids), S, _t(mask)
    ).numpy()
    assert got.shape == (3, S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fused_typed_rows_together(strategy):
    """Every kind in one lane, presence rows between them, no mask."""
    gids, _, _, _ = _inputs(8)
    rng = np.random.default_rng(9)
    typed = [_typed_row(rng, k) for k in TYPED_KINDS]
    mask = np.ones(N, bool)
    want = _ref_fused([w for _, _, w in typed], gids, mask, presence=2)
    rows = [_port_row(v, off) for v, off, _ in typed]
    got = segment.fused_segment_sums(
        rows[:2] + [segment.PRESENCE] + rows[2:] + [segment.PRESENCE], _t(gids), S
    ).numpy()
    order = [0, 1, 3, 4, 5, 2, 6, 7]  # where each of want's rows lands in got
    for i, j in enumerate(order):
        np.testing.assert_array_equal(got[j], want[i])


# ---------------------------------------------------------------- H1 lanes
# H1's lane chooser as a pure function: every S in exactly one lane, each
# lane's shared bytes within the opt-in limit, a cluster's group slices
# covering [0, S) once.
_S_GRID = [1, 7, 8, 9, 16, 17, 31, 32, 33, 64, 4095, 4096, 4097, 32768, 65536, 1 << 20]


@pytest.mark.parametrize("optin", [48 * 1024, 101_376, 232_448])
def test_h1_lane_chooser_grid(optin):
    from pixie_tpu_torch.ops import kernels

    for R in range(0, 6):
        last = None
        for S in _S_GRID:
            lane, arg = kernels.h1_lane(R, S, optin)
            assert lane in ("regs", "cluster", "global")
            if lane == "regs":
                assert S <= kernels.H1_REGS_MAX_S and arg in (8, 16, 32) and S <= arg
                assert arg // 2 < S or arg == 8
                # the register lane's static partial: counts and two rows
                assert arg * (4 + 8 * 2) <= 48 * 1024
            elif lane == "cluster":
                assert S > kernels.H1_REGS_MAX_S and arg == kernels.H1_CLUSTER
                assert kernels.h1_partial_bytes(R, S) <= optin
            else:
                assert kernels.h1_partial_bytes(R, S) > optin
            # lanes only widen with S: regs, then cluster, then global
            order = ("regs", "cluster", "global")
            assert last is None or order.index(lane) >= order.index(last)
            last = lane
    with pytest.raises(ValueError):
        kernels.h1_lane(1, 0, optin)


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_h1_cluster_slices_cover_groups(cluster):
    from pixie_tpu_torch.ops import kernels

    for S in _S_GRID:
        slices = kernels.cluster_slices(S, cluster)
        assert len(slices) == cluster
        covered = np.zeros(S, np.int64)
        for lo, hi in slices:
            assert 0 <= lo <= hi <= S
            covered[lo:hi] += 1
        assert (covered == 1).all()
        # contiguous in rank order, as the kernel's rank * slice bounds are
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


# ---------------------------------------------------------------- the f64 lane
# H2's plain version (segment.f64_segment_sums on CPU tensors) against the
# reference's seg_sum over the same f64 values: f64 rows, and integer or
# bool rows as the fold stages them (a Narrow's offset added, then rounded
# to f64), each summed or squared (variance's col * col). Held within
# 1e-12 * sum |v| of math.fsum (the Fault-17 bound) and exactly where every
# value and every sum of a group is an integer below 2^53; against the
# reference's scatter lane within 1e-12 * sum |v|, its matmul lane within
# that plus the lane's own chunk bound.
F64_KINDS = ("bool", "uint8", "uint16", "int32", "int64", "float64")
_F64_OFFSETS = {"bool": 0, "uint8": 5, "uint16": 70_000, "int32": -1000, "int64": 0,
                "float64": 0}


def _f64_row(rng, kind: str, square: bool, off=None):
    """(the port's F64Row, the reference's f64 values: col.astype(f64), squared
    as col * col)."""
    if kind == "float64":
        v = rng.normal(0.0, 1e6, N)
        v[::97] = rng.exponential(3e7, v[::97].size)
        port, wide = _t(v), v
    else:
        if kind == "bool":
            v = rng.random(N) < 0.5
        elif kind == "int64":
            v = rng.integers(-(2**40), 2**40, N, dtype=np.int64)
        else:
            info = np.iinfo(kind)
            v = rng.integers(max(int(info.min), -(2**31)), int(info.max) + 1, N).astype(kind)
        off = _F64_OFFSETS[kind] if off is None else off
        wide = (v.astype(np.int64).view(np.uint64) + np.uint64(off % (1 << 64))).view(np.int64)
        port = _port_row(v, off)
    x = jnp.asarray(wide).astype(jnp.float64)
    return segment.F64Row(port, square), np.asarray(x * x if square else x)


def _fsum_groups(x: np.ndarray, gids, mask) -> tuple:
    import math

    ok = mask & (gids >= 0) & (gids < S)
    exact = np.array([math.fsum(x[ok & (gids == g)]) for g in range(S)])
    abs_sum = np.array([math.fsum(np.abs(x[ok & (gids == g)])) for g in range(S)])
    return exact, abs_sum


def _hold_f64(got: np.ndarray, x: np.ndarray, gids, mask, strategy) -> None:
    exact, abs_sum = _fsum_groups(x, gids, mask)
    if np.all(x == np.round(x)) and abs_sum.max() < 2.0**53:
        np.testing.assert_array_equal(got, exact)
    assert np.all(np.abs(got - exact) <= 1e-12 * abs_sum)
    want = np.asarray(ref_segment.seg_sum(jnp.asarray(x), jnp.asarray(gids), S, jnp.asarray(mask)))
    lane = ref_segment._F64_CHUNK * 2.0**-24 if strategy == "matmul" else 0.0
    assert np.all(np.abs(got - want) <= (1e-12 + lane) * abs_sum)


def _f64_gids(seed: int):
    gids, mask, _, _ = _inputs(seed)
    gids[gids == 5] = S + 1  # group 5 stays empty
    return gids, mask


@pytest.mark.parametrize("square", [False, True], ids=["value", "square"])
@pytest.mark.parametrize("kind", F64_KINDS)
def test_f64_lane_row_matches_reference(strategy, kind, square):
    """One row of each kind and op: masked rows, gids out of range, an
    empty group."""
    gids, mask = _f64_gids(11)
    row, x = _f64_row(np.random.default_rng(12), kind, square)
    got = segment.f64_segment_sums([row], _t(gids), S, _t(mask)).numpy()
    assert got.shape == (1, S) and got.dtype == np.float64 and got[0, 5] == 0.0
    _hold_f64(got[0], x, gids, mask, strategy)


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5])
def test_f64_lane_rows_together(strategy, R):
    """R rows of mixed kinds and ops in one call, each held as alone; the
    narrowed value rows with offsets near the int64 edge (v + off wraps;
    their squares would pass the f32 range of the reference's matmul
    lane)."""
    gids, mask = _f64_gids(13)
    rng = np.random.default_rng(14 + R)
    picks = [(F64_KINDS[(3 * i + R) % len(F64_KINDS)], (i + R) % 2 == 1) for i in range(R)]
    rows = [_f64_row(rng, k, sq, None if sq else _OFFSETS.get(k))
            for k, sq in picks]
    got = segment.f64_segment_sums([r for r, _ in rows], _t(gids), S, _t(mask)).numpy()
    assert got.shape == (R, S)
    for r, (_, x) in enumerate(rows):
        _hold_f64(got[r], x, gids, mask, strategy)
    alone = segment.f64_segment_sums([rows[0][0]], _t(gids), S, None).numpy()
    _hold_f64(alone[0], rows[0][1], gids, np.ones(N, bool), strategy)


@pytest.mark.parametrize("square", [False, True], ids=["value", "square"])
def test_f64_lane_nonfinite_propagates(square):
    """NaN and +-inf propagate as the reference's scatter lane adds them
    (the matmul lane's one-hot products spread a NaN over every group):
    NaN where a group holds a NaN or both infinities, the infinity where it
    holds one kind, the finite sum elsewhere."""
    gids, mask = _f64_gids(15)
    v = np.random.default_rng(16).normal(0.0, 1e3, N)
    ok = mask & (gids >= 0) & (gids < S)
    rows = np.flatnonzero(ok)
    first = {g: rows[gids[rows] == g][:2] for g in (0, 1, 2, 3)}
    v[first[0][0]] = np.nan
    v[first[1][0]], v[first[1][1]] = np.inf, -np.inf
    v[first[2][0]] = np.inf
    v[first[3][0]] = -np.inf
    v[np.flatnonzero(~ok)[:5]] = np.nan  # masked and out-of-range NaN: ignored
    x = v * v if square else v
    ref_segment.set_strategy("scatter")
    try:
        want = np.asarray(ref_segment.seg_sum(jnp.asarray(x), jnp.asarray(gids), S,
                                              jnp.asarray(mask)))
    finally:
        ref_segment.set_strategy(None)
    got = segment.f64_segment_sums([segment.F64Row(_t(v), square)], _t(gids), S,
                                   _t(mask)).numpy()[0]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    assert np.isnan(got[0]) and np.isnan(got[1]) == (not square) and got[2] == np.inf
    fin = np.isfinite(want)
    _, abs_sum = _fsum_groups(np.where(np.isfinite(x), x, 0.0), gids, mask)
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-12 * abs_sum[fin])


def test_seg_sum_f64_is_the_f64_lane():
    """seg_sum over f64 values is the f64 lane's single value row."""
    gids, mask, _, floats = _inputs(17)
    got = segment.seg_sum(_t(floats), _t(gids), S, _t(mask))
    want = segment.f64_segment_sums([segment.F64Row(_t(floats))], _t(gids), S, _t(mask))[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("optin", [48 * 1024, 101_376, 232_448])
def test_h2_lane_chooser_grid(optin):
    """H2's lanes as a pure function: up to 64 groups at most 4 rows a
    launch, private cells while rows x S's bucket <= 64, else the warp
    lane; shared partials while k rows fit the opt-in bytes, then global
    atomics; lanes only widen with S."""
    from pixie_tpu_torch.ops import kernels

    order = ("private", "warps", "shared", "global")
    for R in range(1, 9):
        last = None
        for S_ in _S_GRID:
            lane, per = kernels.h2_lane(R, S_, optin)
            assert 1 <= per <= R
            if lane in ("private", "warps"):
                assert S_ <= kernels.H2_WARP_MAX_S and per == min(R, kernels.H2_WARP_ROWS)
                cells = per * kernels.h2_bucket(S_)
                assert (cells <= kernels.H2_PRIVATE_CELLS) == (lane == "private")
                assert S_ <= kernels.h2_bucket(S_) < 2 * max(S_, 8)
            elif lane == "shared":
                assert S_ > kernels.H2_WARP_MAX_S and per * S_ * 8 <= optin
                assert per == R or (per + 1) * S_ * 8 > optin or per == kernels.H2_MAX_ROWS
            else:
                assert S_ * 8 > optin
            assert last is None or order.index(lane) >= order.index(last)
            last = lane
    with pytest.raises(ValueError):
        kernels.h2_lane(1, 0, optin)
    assert kernels.h2_grid(1 << 21, 132, "warps", 3, 64) == 132
    assert kernels.h2_grid(4096, 132, "warps", 3, 64) == 1
    assert kernels.h2_grid(1, 132, "private", 1, 16) == 1
    assert kernels.h2_grid(1 << 21, 132, "private", 1, 16) == 264
    assert kernels.h2_grid(1 << 21, 132, "private", 1, 64) == 132
    for S_ in range(1, kernels.H2_WARP_MAX_S + 1):  # one row never takes the warp lane
        assert kernels.h2_lane(1, S_, optin)[0] == "private"


@pytest.mark.parametrize("optin", [48 * 1024, 232_448])
def test_h2_parts_cover_rows(optin):
    """H2's launches for R rows: every row once in order, the warp lane
    never with one row, the private lane within its cells, and the scratch
    the wrapper sizes (the largest part's CTAs x rows) enough for every
    part."""
    from pixie_tpu_torch.ops import kernels

    for R in range(1, 13):
        for S_ in _S_GRID:
            for n in (1, 4099, 1 << 21):
                parts = kernels.h2_parts(R, S_, n, 132, optin)
                assert [lo for lo, _, _, _ in parts] == list(np.cumsum([0] + [r for _, r, _, _ in parts])[:-1])
                assert sum(r for _, r, _, _ in parts) == R
                scratch = max(g * r for _, r, _, g in parts)
                for _, r, lane, grid in parts:
                    assert lane != "warps" or r >= 2
                    if lane == "private":
                        assert r * kernels.h2_bucket(S_) <= kernels.H2_PRIVATE_CELLS
                    if lane in ("private", "warps"):
                        assert 1 <= grid and grid * r <= scratch
                    else:
                        assert grid == 0

