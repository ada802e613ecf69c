"""Parity of the port's segment min/max/any (the plain version of H11) and
the min, max and any UDAs with pixie_tpu.ops.segment and the reference's
UDAs on the CPU, under both reference lanes: the scatter lane and the
sort-compact lane (``segment.set_sorted_strategy(False | True)``).

Held bit for bit on every group with no NaN, not holding both zeros and
whose extreme is not subnormal, over int64 and f64, with masks, empty
segments (the identity fills) and gids at or past the segment count.
Fault-5 (PERF.md): the port follows the scatter lane on NaN (it propagates
under min and max) and on signed zeros (-0.0 < +0.0, whatever the row
order), where the sort-compact lane differs; it keeps a subnormal extreme,
as the sort-compact lane does, where XLA-CPU's scatter min/max flush it to
a zero of its sign. ``test_fault5_*`` pin all three. The UDA states cross between
the packages through ``interop.state_from_numpy`` / ``state_to_numpy``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.types import DataType as RefDT
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu_torch import interop
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import default_registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

N = 20_000


@pytest.fixture(params=[False, True], ids=["scatter", "sorted_compact"])
def sorted_lane(request):
    ref_segment.set_sorted_strategy(request.param)
    yield request.param
    ref_segment.set_sorted_strategy(None)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _rows(seed: int, S: int, kind: str, negative_gids: bool):
    """Rows over gids [0, S - 8) (the last 8 segments stay empty) plus a few
    gids at or past S (and below 0 when ``negative_gids``); f64 values
    without NaN, zeros or subnormals (the Fault-5 cases, pinned below)."""
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, S - 8, N).astype(np.int32)
    gids[:50] = S + rng.integers(0, 5, 50)
    if negative_gids:
        gids[50:100] = -1 - rng.integers(0, 5, 50)
    mask = rng.random(N) < 0.8
    if kind == "int64":
        vals = rng.integers(-(2**63), 2**63 - 1, N, dtype=np.int64)
        vals[100:104] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    else:
        vals = rng.normal(0.0, 1e6, N)
        tiny = np.finfo(np.float64).tiny  # the smallest normal
        vals[100:106] = [np.inf, -np.inf, tiny, -tiny, 1e308, -1e308]
        vals[vals == 0] = 1.0
    return gids, mask, vals


@pytest.mark.parametrize("kind", ["int64", "float64"])
@pytest.mark.parametrize("S", [16, 4096])
def test_seg_min_max_match_reference(sorted_lane, kind, S):
    gids, mask, vals = _rows(S, S, kind, negative_gids=not sorted_lane)
    for use_mask in (False, True):
        m_ref = jnp.asarray(mask) if use_mask else None
        m_port = _t(mask) if use_mask else None
        for ref_fn, fn in ((ref_segment.seg_min, segment.seg_min),
                           (ref_segment.seg_max, segment.seg_max)):
            want = np.asarray(ref_fn(jnp.asarray(vals), jnp.asarray(gids), S, m_ref))
            got = fn(_t(vals), _t(gids), S, m_port).numpy()
            assert got.dtype == want.dtype
            assert np.array_equal(_bits(got), _bits(want)), (ref_fn.__name__, use_mask)
    # The empty segments hold the identity fills.
    assert np.all(segment.seg_min(_t(vals), _t(gids), S).numpy()[-8:] == (
        np.inf if kind == "float64" else np.iinfo(np.int64).max))
    assert segment._identity_for(torch.float64, False) == -np.inf
    assert segment._identity_for(torch.int64, False) == np.iinfo(np.int64).min


def test_seg_any_matches_reference():
    """seg_any reads True on a segment no row reaches (the identity cast to
    bool) and False on one whose rows are all masked, as the reference's."""
    rng = np.random.default_rng(3)
    S = 64
    gids = rng.integers(-2, S, 5_000).astype(np.int32)
    gids[gids == 7] = 8  # segment 7: no row at all
    vals = rng.random(5_000) < 0.01
    mask = rng.random(5_000) < 0.5
    mask[gids == 9] = False  # segment 9: every row masked
    for m in (None, mask):
        want = np.asarray(ref_segment.seg_any(
            jnp.asarray(vals), jnp.asarray(gids), S, None if m is None else jnp.asarray(m)))
        got = segment.seg_any(_t(vals), _t(gids), S, None if m is None else _t(m)).numpy()
        assert np.array_equal(got, want)
    assert got[7] and not got[9]


def _uda_pair(name: str, arg_t: str):
    ref = ref_registry().lookup_uda(name, [getattr(RefDT, arg_t)])
    port = default_registry().lookup_uda(name, [getattr(DataType, arg_t)])
    assert ref is not None and port is not None
    return ref, port


@pytest.mark.parametrize("name", ["min", "max"])
@pytest.mark.parametrize("arg_t", ["FLOAT64", "INT64"])
def test_minmax_udas_match_reference(sorted_lane, name, arg_t):
    """init, three blocks of update (the reference's state carried into the
    port through interop before each), merge of two partial states, and
    finalize, which maps an untouched group (the identity) to 0."""
    G = 300
    ref, port = _uda_pair(name, arg_t)
    kind = "float64" if arg_t == "FLOAT64" else "int64"
    st_ref = ref.init(G)
    st_port = port.init(G, "cpu")
    assert np.array_equal(_bits(interop.state_to_numpy(port, st_port)), _bits(st_ref))
    for blk in range(3):
        gids, mask, vals = _rows(10 + blk, G, kind, negative_gids=not sorted_lane)
        if kind == "int64":
            vals //= 1 << 20  # int64 columns of realistic range
        st_ref = ref.update(st_ref, jnp.asarray(gids), jnp.asarray(vals), mask=jnp.asarray(mask))
        st_port = port.update(st_port, _t(gids), _t(vals), mask=_t(mask))
        assert np.array_equal(_bits(interop.state_to_numpy(port, st_port)), _bits(st_ref))
        st_port = interop.state_from_numpy(port, np.asarray(st_ref))
    other_ref = ref.update(ref.init(G), jnp.asarray(gids[::-1].copy()), jnp.asarray(vals))
    other = interop.state_from_numpy(port, np.asarray(other_ref))
    merged_ref = ref.merge(st_ref, other_ref)
    merged = port.merge(st_port, other)
    assert np.array_equal(_bits(merged.numpy()), _bits(merged_ref))
    want = np.asarray(ref.finalize(merged_ref))
    got = port.finalize(merged).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.all(got[-8:] == 0)  # empty groups finalize to 0


@pytest.mark.parametrize("arg_t", ["FLOAT64", "INT64", "STRING", "BOOLEAN", "TIME64NS"])
def test_any_uda_matches_reference(sorted_lane, arg_t):
    """any() as the max of the values (codes for strings, 0/1 for bools)."""
    G = 64
    ref, port = _uda_pair("any", arg_t)
    assert port.string_args == "code" and port.string_state == (arg_t == "STRING")
    rng = np.random.default_rng(5)
    gids = rng.integers(0, G - 4, N).astype(np.int32)
    mask = rng.random(N) < 0.7
    vals = {
        "FLOAT64": rng.normal(0.0, 1e3, N),
        "INT64": rng.integers(-(1 << 40), 1 << 40, N, dtype=np.int64),
        "STRING": rng.integers(0, 4096, N).astype(np.int32),  # dictionary codes
        "BOOLEAN": rng.random(N) < 0.001,
        "TIME64NS": np.arange(N, dtype=np.int64) * 1000,
    }[arg_t]
    st_ref = ref.update(ref.init(G), jnp.asarray(gids), jnp.asarray(vals), mask=jnp.asarray(mask))
    st_port = port.update(port.init(G, "cpu"), _t(gids), _t(vals), mask=_t(mask))
    assert np.array_equal(_bits(st_port.numpy()), _bits(st_ref))
    assert np.array_equal(_bits(port.finalize(st_port).numpy()), _bits(ref.finalize(st_ref)))
    back = interop.state_from_numpy(port, np.asarray(st_ref))
    assert np.array_equal(_bits(port.merge(back, st_port).numpy()), _bits(ref.merge(st_ref, st_ref)))


def _fault5_rows():
    """Group 0: {1, NaN, 3}; group 1: [+0.0, -0.0]; group 2: [-0.0, +0.0];
    group 3: only NaN; group 4: -inf; group 5: {5e-324, -3} (a subnormal
    max); group 6: {-5e-324, 3} (a subnormal min)."""
    vals = np.array([1.0, np.nan, 3.0, 0.0, -0.0, -0.0, 0.0, np.nan, -np.inf,
                     5e-324, -3.0, -5e-324, 3.0])
    gids = np.array([0, 0, 0, 1, 1, 2, 2, 3, 4, 5, 5, 6, 6], np.int32)
    return vals, gids


def _ref_lane(sorted_lane: bool, vals, gids, S: int):
    ref_segment.set_sorted_strategy(sorted_lane)
    try:
        return (np.asarray(ref_segment.seg_min(jnp.asarray(vals), jnp.asarray(gids), S)),
                np.asarray(ref_segment.seg_max(jnp.asarray(vals), jnp.asarray(gids), S)))
    finally:
        ref_segment.set_sorted_strategy(None)


def test_fault5_port_follows_the_scatter_lane():
    """NaN propagates under min and max; -0.0 < +0.0 in either row order; a
    winning NaN is the canonical quiet NaN, bit for bit with H11; a NaN
    already in the state stays. A subnormal extreme, which XLA-CPU's
    scatter min/max flush to a zero of its sign, the port keeps."""
    vals, gids = _fault5_rows()
    want_mn, want_mx = _ref_lane(False, vals, gids, 7)
    mn = segment.seg_min(_t(vals), _t(gids), 7).numpy()
    mx = segment.seg_max(_t(vals), _t(gids), 7).numpy()
    for got, want in ((mn, want_mn), (mx, want_mx)):
        assert np.array_equal(np.isnan(got[:5]), np.isnan(want[:5]))
        ok = ~np.isnan(want[:5])
        assert np.array_equal(_bits(got[:5][ok]), _bits(want[:5][ok]))  # signs of zero too
    assert np.isnan(mx[0]) and np.isnan(mn[0]) and np.isnan(mx[3]) and np.isnan(mn[3])
    assert mx[0].view(np.int64) == 0x7FF8000000000000  # the canonical NaN
    assert not np.signbit(mx[1]) and not np.signbit(mx[2])
    assert np.signbit(mn[1]) and np.signbit(mn[2])
    assert mx[5] == 5e-324 and mn[6] == -5e-324  # kept
    assert _bits(want_mx[5]) == 0 and _bits(want_mn[6]) == _bits(-0.0)  # flushed
    nan_bits = np.array([-0x7FFFFFFFFFFFF], np.int64)  # a negative NaN with a payload
    st = _t(nan_bits.view(np.float64))
    segment.segment_minmax_plain(st, _t(np.array([5.0])), _t(np.array([0], np.int32)), None, False)
    assert np.array_equal(st.numpy().view(np.int64), nan_bits)


def test_fault5_sorted_lane_differs_on_nan_and_signed_zeros():
    """The sort-compact lane: max propagates NaN, min skips it unless every
    value is NaN; ties between the zeros go by row position; subnormals are
    kept, as the port keeps them. If the reference changes any of it,
    Fault-5's contract must be revisited."""
    vals, gids = _fault5_rows()
    mn, mx = _ref_lane(True, vals, gids, 7)
    assert np.isnan(mx[0]) and mn[0] == 1.0 and np.isnan(mn[3])
    assert np.signbit(mx[1]) and not np.signbit(mn[1])  # [+0.0, -0.0]
    assert not np.signbit(mx[2]) and np.signbit(mn[2])  # [-0.0, +0.0]
    assert mx[5] == 5e-324 and mn[6] == -5e-324
    port_mn = segment.seg_min(_t(vals), _t(gids), 7).numpy()
    port_mx = segment.seg_max(_t(vals), _t(gids), 7).numpy()
    assert np.array_equal(_bits(port_mx[4:]), _bits(mx[4:]))
    assert np.array_equal(_bits(port_mn[4:]), _bits(mn[4:]))
    # Negative gids wrap around in this lane (no pipeline passes one); the
    # scatter lane and the port drop them.
    ref_segment.set_sorted_strategy(True)
    try:
        neg = np.asarray(ref_segment.seg_max(
            jnp.asarray(np.array([5, 7], np.int64)), jnp.asarray(np.array([-1, 0], np.int32)), 3))
    finally:
        ref_segment.set_sorted_strategy(None)
    assert neg[2] == 5
    port = segment.seg_max(_t(np.array([5, 7], np.int64)), _t(np.array([-1, 0], np.int32)), 3)
    assert port.tolist() == [7, np.iinfo(np.int64).min, np.iinfo(np.int64).min]


# ---------------------------------------------------------------- staged columns
# H11 reads a column where the fold staged it: uint8, uint16 or int32 with
# its frame-of-reference offset, added in registers before any comparison.
# staging._narrow_int stores value - min, non-negative and within its type,
# so value + offset never wraps and the staged order is the int64 order. The
# port takes a segment.Narrow; the reference gets the widened int64 column.
# Staged values include both ends of the type's range; offsets are 0,
# negative, large, and as near INT64_MAX and INT64_MIN as the range allows.
_I64 = np.iinfo(np.int64)
_NARROW_DTYPES = {"uint8": (np.uint8, 255), "uint16": (np.uint16, 65535),
                  "int32": (np.int32, 2**31 - 1)}
_OFFSETS = {
    "zero": lambda top: 0,
    "negative": lambda top: -1_000_003,
    "large": lambda top: 1 << 40,
    "near_max": lambda top: int(_I64.max) - top,
    "near_min": lambda top: int(_I64.min),
}


def _narrow_rows(seed: int, S: int, dt: str, off_case: str):
    """(gids, mask, staged values, offset, the widened int64 column)."""
    np_dt, top = _NARROW_DTYPES[dt]
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, S - 4, N).astype(np.int32)
    gids[:40] = S + rng.integers(0, 3, 40)
    mask = rng.random(N) < 0.8
    staged = rng.integers(0, top + 1, N).astype(np_dt)
    staged[40:44] = [0, top, 0, top]
    gids[40:44] = [1, 1, 2, 2]  # each end in one group, both in another
    staged[44:46] = [top, 0]
    gids[44:46] = 3
    mask[40:46] = True
    off = _OFFSETS[off_case](top)
    wide = staged.astype(np.int64) + off  # within int64: no wrap
    return gids, mask, staged, off, wide


@pytest.mark.parametrize("off_case", list(_OFFSETS))
@pytest.mark.parametrize("dt", list(_NARROW_DTYPES))
def test_seg_min_max_narrow_match_reference(sorted_lane, dt, off_case):
    S = 64
    gids, mask, staged, off, wide = _narrow_rows(len(dt) + len(off_case), S, dt, off_case)
    col = segment.Narrow(_t(staged), off)
    for use_mask in (False, True):
        m_ref = jnp.asarray(mask) if use_mask else None
        m_port = _t(mask) if use_mask else None
        for ref_fn, fn in ((ref_segment.seg_min, segment.seg_min),
                           (ref_segment.seg_max, segment.seg_max)):
            want = np.asarray(ref_fn(jnp.asarray(wide), jnp.asarray(gids), S, m_ref))
            got = fn(col, _t(gids), S, m_port).numpy()
            assert got.dtype == np.int64 and np.array_equal(got, want), (ref_fn.__name__, use_mask)
    mn = segment.seg_min(col, _t(gids), S).numpy()
    mx = segment.seg_max(col, _t(gids), S).numpy()
    top = _NARROW_DTYPES[dt][1]
    assert mn[1] == off and mx[1] == off + top  # the type's ends, offset
    assert mn[3] == off and mx[3] == off + top


@pytest.mark.parametrize("dt", list(_NARROW_DTYPES))
@pytest.mark.parametrize("name", ["min", "max"])
def test_minmax_udas_narrow_match_reference(sorted_lane, name, dt):
    """The INT64 min and max take a narrowed column as staged
    (``narrow_args``; the FLOAT64 ones do not): three blocks of update over
    Narrow columns with different offsets, against the reference's UDA over
    the widened columns."""
    G = 300
    ref, port = _uda_pair(name, "INT64")
    assert port.narrow_args and not _uda_pair(name, "FLOAT64")[1].narrow_args
    st_ref, st_port = ref.init(G), port.init(G, "cpu")
    for blk, off_case in enumerate(("negative", "near_max", "zero")):
        gids, mask, staged, off, wide = _narrow_rows(30 + blk, G, dt, off_case)
        st_ref = ref.update(st_ref, jnp.asarray(gids), jnp.asarray(wide), mask=jnp.asarray(mask))
        st_port = port.update(st_port, _t(gids), segment.Narrow(_t(staged), off), mask=_t(mask))
        assert np.array_equal(interop.state_to_numpy(port, st_port), np.asarray(st_ref)), blk
    assert np.array_equal(port.finalize(st_port).numpy(), np.asarray(ref.finalize(st_ref)))


# ---------------------------------------------------------------- H11 lanes
# H11's lane chooser as a pure function: every S in exactly one lane, the
# register lane's bucket the smallest that holds S (S <= 8), the cluster lane
# only while S 8-byte keys fit a block's opt-in shared memory.
_S_GRID = [1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 64, 4095, 4096, 4097, 6144, 6145, 12288,
           29056, 29057, 32768, 1 << 20]


@pytest.mark.parametrize("optin", [48 * 1024, 101_376, 232_448])
def test_h11_lane_chooser_grid(optin):
    from pixie_tpu_torch.ops import kernels

    order = ("regs", "cluster", "global")
    last = None
    for S in _S_GRID:
        lane, arg = kernels.h11_lane(S, optin)
        if lane == "regs":
            assert S <= 8 and arg in kernels.H11_REGS_BUCKETS and S <= arg
            smaller = [b for b in kernels.H11_REGS_BUCKETS if b < arg]
            assert not smaller or smaller[-1] < S
            assert (arg == 1) == (S == 1)  # one group: a register a thread
            assert arg * 256 * 8 <= 16 * 1024  # private cells of 256 threads
        elif lane == "cluster":
            assert S > 8 and arg == kernels.H11_CLUSTER and S * 8 <= optin
        else:
            assert lane == "global" and arg == 0 and S * 8 > optin
        assert last is None or order.index(lane) >= order.index(last)
        last = lane
    # The paths' shapes: flow_window S = 1, the join aggregates' 4 and 5,
    # config 10's S = 64, flows' 4096.
    assert kernels.h11_lane(1, optin) == ("regs", 1)
    assert kernels.h11_lane(5, optin) == ("regs", 8)
    assert kernels.h11_lane(16, optin) == ("cluster", kernels.H11_CLUSTER)
    assert kernels.h11_lane(64, optin) == ("cluster", kernels.H11_CLUSTER)
    assert kernels.h11_lane(4096, optin)[0] == ("cluster" if optin >= 32768 else "global")
    for bad in (0, -1):
        with pytest.raises(ValueError):
            kernels.h11_lane(bad, optin)
