"""The staging codec of the port (pixie_tpu_torch/ops/codec.py) against the
reference's (pixie_tpu/ops/codec.py), on the same seeded numpy columns.

Held bit for bit: the plans (every field) and payload arrays of
``plan_codec``, ``plan_codec_local`` and ``encode_window``; the plain
decodes (H18's and H19's plain versions, on CPU tensors) against the
reference's jitted ``_decoder`` on a CPU mesh of the same shard count, and
against the packed column itself, for every block dtype, NaN payloads
included. Then the reference's own cases (tests/test_codec.py:74-806):
round trips, NaN floats, all-equal, empty and singleton, overflow, nibble
deltas, the gid stream and a fuzz, each a parametrised case, and a query
grouped by a sorted key whose gid lane rides the codec, codec on against
codec off bit for bit and against the reference (f64 sums within H2's bound,
1e-12 relative: the port adds in another order than XLA).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import codec as ref_codec
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.parallel import staging as ref_staging
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import codec, kernels, segment
from pixie_tpu_torch.parallel import DeviceExecutor, staging
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.utils import flags

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

NBLK, B = 2, 256


def _mesh(d: int) -> Mesh:
    return Mesh(np.array(jax.devices("cpu")[:d]), ("d",))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _padded(vals, rows, dtype, d=1):
    flat = np.zeros(d * NBLK * B, dtype=dtype)
    flat[:rows] = np.asarray(vals)[:rows]
    return flat


def _port_decode(payload, d: int) -> np.ndarray:
    """The plain decode of a payload into a fresh [d, L] block (CPU)."""
    plan = payload.plan
    out = torch.zeros((d, plan.shard_len), dtype=codec.TORCH_DTYPES[np.dtype(plan.dtype)])
    codec.decode([torch.from_numpy(np.ascontiguousarray(a)) for a in payload.arrays], plan, out)
    return out.numpy()


def _ref_decode(payload, d: int) -> np.ndarray:
    mesh = _mesh(d)
    args = ref_codec.put_payload(mesh, payload)
    return np.asarray(ref_codec.decoder(mesh, payload.plan, NBLK, B)(*args)).reshape(d, -1)


def _assert_same_payload(got, want):
    assert got.plan == codec.CodecPlan(**want.plan.__dict__)
    assert len(got.arrays) == len(want.arrays)
    for a, b in zip(got.arrays, want.arrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


def _roundtrip(flat, rows, min_ratio=1.1, d=1):
    """(plan, decoded) through the port, decoded None when it passes; the
    plan, payload and decode are held against the reference's."""
    plan = codec.plan_codec_local(flat, d, NBLK, B, rows, min_ratio)
    want_plan = ref_codec.plan_codec_local(flat, d, NBLK, B, rows, min_ratio)
    assert (plan is None) == (want_plan is None)
    if plan is None:
        return None, None
    assert plan == codec.CodecPlan(**want_plan.__dict__)
    payload = codec.encode_window(flat, plan, rows)
    _assert_same_payload(payload, ref_codec.encode_window(flat, want_plan, rows))
    out = _port_decode(payload, d)
    assert np.array_equal(_bits(out), _bits(_ref_decode(payload, d)))
    return plan, out


# -- columns of every shape the planner meets ------------------------------------


def _columns():
    rng = np.random.default_rng(3)
    L = NBLK * B
    nan_runs = np.repeat(rng.standard_normal(L // 128 + 1), 128)[:L].copy()
    nan_runs[::5] = np.nan
    nan_runs[7] = np.frombuffer(np.uint64(0x7FF80000DEADBEEF).tobytes(), np.float64)[0]
    return {
        "timestamps_i64": (np.arange(L, dtype=np.int64) * 1000 + (5 << 40), L - 137),
        "runs_i64": (np.repeat(rng.integers(0, 4, L // 64 + 1), 64)[:L].astype(np.int64), L - 5),
        "nan_runs_f64": (nan_runs, L - 9),
        "f32_runs": (np.repeat(rng.standard_normal(L // 32 + 1), 32)[:L].astype(np.float32), L),
        "all_equal_i64": (np.full(L, 42, np.int64), L),
        "singleton_i64": (np.array([99], np.int64), 1),
        "nibble_i64": (np.arange(L, dtype=np.int64) * 8 + (3 << 41), L - 31),
        "u8_deltas_i32": (np.cumsum(rng.integers(0, 200, L)).astype(np.int32), L),
        "u16_deltas_i64": (np.cumsum(rng.integers(-5000, 20000, L)).astype(np.int64), L - 3),
        "sorted_u8_codes": (np.sort(rng.integers(0, 200, L)).astype(np.uint8), L),
        "sorted_u16_gids": (np.sort(rng.integers(0, 3000, L)).astype(np.uint16), L - 1),
        "random_f64": (rng.standard_normal(L), L),
        "wide_random_i64": (rng.integers(0, 1 << 40, L), L),
    }


COLUMNS = _columns()


@pytest.mark.parametrize("name", sorted(COLUMNS))
@pytest.mark.parametrize("d", [1, 8])
def test_plan_payload_and_decode_match_reference(name, d):
    vals, rows = COLUMNS[name]
    if d > 1:  # the same column over d shards
        vals = np.resize(vals, d * NBLK * B)
        rows = min(d * NBLK * B - 3, len(vals)) if rows > 1 else rows
    flat = _padded(vals, rows, vals.dtype, d)
    plan, out = _roundtrip(flat, rows, d=d)
    if plan is not None:
        assert np.array_equal(_bits(out.reshape(-1)), _bits(flat))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_stream_plan_matches_reference(name):
    """plan_codec over a column cut into windows (the stream's planner, from
    the raw column's statistics) equals the reference's, and so does every
    window's payload."""
    vals, rows = COLUMNS[name]
    window = NBLK * B // 2
    for affine in (True, False):
        got = codec.plan_codec(vals[:rows], vals.dtype, 1, 1, window, window, rows, 1.1, affine)
        want = ref_codec.plan_codec(vals[:rows], vals.dtype, 1, 1, window, window, rows, 1.1,
                                    affine)
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert got == codec.CodecPlan(**want.__dict__)
        for lo in range(0, rows, window):
            r = min(window, rows - lo)
            flat = np.zeros(window, vals.dtype)
            flat[:r] = vals[lo : lo + r]
            try:
                want_p = ref_codec.encode_window(flat, want, r)
            except ref_codec.CodecOverflow:
                with pytest.raises(codec.CodecOverflow):
                    codec.encode_window(flat, got, r)
                continue
            _assert_same_payload(codec.encode_window(flat, got, r), want_p)


# -- the reference's cases (tests/test_codec.py) ----------------------------------


def test_delta_roundtrip_timestamps():
    vals, rows = COLUMNS["timestamps_i64"]
    flat = _padded(vals, rows, np.int64)
    plan, out = _roundtrip(flat, rows)
    assert plan is not None and plan.kind == "delta"
    assert np.array_equal(out.reshape(-1), flat)


def test_rle_roundtrip_runs():
    vals, rows = COLUMNS["runs_i64"]
    flat = _padded(vals, rows, np.int64)
    plan, out = _roundtrip(flat, rows)
    assert plan is not None and plan.kind == "rle"
    assert np.array_equal(out.reshape(-1), flat)


def test_rle_nan_floats_bit_exact():
    vals, rows = COLUMNS["nan_runs_f64"]
    flat = _padded(vals, rows, np.float64)
    plan, out = _roundtrip(flat, rows)
    assert plan is not None and plan.kind == "rle"
    assert np.array_equal(_bits(out.reshape(-1)), _bits(flat))


def test_all_equal_column():
    flat = np.full(NBLK * B, 42, np.int64)
    plan, out = _roundtrip(flat, NBLK * B)
    assert plan is not None
    assert np.array_equal(out.reshape(-1), flat)


def test_empty_and_singleton():
    flat = np.zeros(NBLK * B, np.int64)
    plan, out = _roundtrip(flat, 0)
    if plan is not None:
        assert np.array_equal(out.reshape(-1), flat)
    flat = _padded(np.array([99], np.int64), 1, np.int64)
    plan, out = _roundtrip(flat, 1)
    assert plan is not None
    assert np.array_equal(out.reshape(-1), flat)


@pytest.mark.parametrize("name", ["wide_random_i64", "random_f64"])
def test_incompressible_columns_pass_through(name):
    vals, rows = COLUMNS[name]
    plan, _ = _roundtrip(_padded(vals, rows, vals.dtype), rows, min_ratio=1.4)
    assert plan is None


def test_encode_overflow_raises_and_pack_ships_raw():
    """A plan a window defeats raises CodecOverflow, and pack_stream_window
    ships that window raw and counts the ``codec_overflow`` lane."""
    total = NBLK * B
    bad = codec.CodecPlan(kind="delta", dtype=np.dtype(np.int64).str, d=1, shard_len=total,
                          delta_dtype=np.dtype(np.uint8).str, delta_off=0)
    hostile = np.random.default_rng(7).integers(0, 1 << 30, total)
    with pytest.raises(codec.CodecOverflow):
        codec.encode_window(hostile, bad, total)
    with pytest.raises(ref_codec.CodecOverflow):
        ref_codec.encode_window(hostile, ref_codec.CodecPlan(**bad.__dict__), total)
    plan = staging.plan_stream({"x": hostile}, total, total, block_rows=B)
    plan.codecs["x"] = bad  # poison the recipe
    segment.reduce_lanes(reset=True)
    _rows, packed, _g, nbytes = staging.pack_stream_window(plan, {"x": hostile}, None, 0)
    assert isinstance(packed["x"], np.ndarray)  # raw, not a payload
    dt, off = plan.col_plans["x"][1]  # narrowed to int32 from its minimum
    want = (hostile - off).astype(dt)
    assert np.array_equal(packed["x"].reshape(-1), want) and nbytes == want.nbytes
    assert segment.reduce_lanes(reset=True) == {"codec_overflow": 1}


@pytest.mark.parametrize("delta_dtype", ["nib", "|u1"])
def test_overflow_guards(delta_dtype):
    """RLE past its run cap and nibble deltas past 4 bits raise in both."""
    total = NBLK * B
    rle = codec.CodecPlan(kind="rle", dtype=np.dtype(np.int64).str, d=1, shard_len=total,
                          runs_cap=2)
    with pytest.raises(codec.CodecOverflow):
        codec.encode_window(np.arange(total, dtype=np.int64), rle, total)
    delta = codec.CodecPlan(kind="delta", dtype=np.dtype(np.int64).str, d=1, shard_len=total,
                            delta_dtype=delta_dtype, delta_off=0)
    hostile = np.cumsum(np.full(total, 300, np.int64))
    with pytest.raises(codec.CodecOverflow):
        codec.encode_window(hostile, delta, total)
    with pytest.raises(ref_codec.CodecOverflow):
        ref_codec.encode_window(hostile, ref_codec.CodecPlan(**delta.__dict__), total)


@pytest.mark.parametrize("trial", range(40))
def test_fuzz_roundtrip_dtype_cardinality_mixes(trial):
    rng = np.random.default_rng(1100 + trial)
    dtype = rng.choice([np.int64, np.int32, np.uint16, np.uint8, np.float64, np.float32])
    total = NBLK * B
    rows = int(rng.integers(0, total + 1))
    kind = rng.integers(0, 4)
    if np.dtype(dtype).kind == "f":
        vals = rng.standard_normal(max(rows, 1)).astype(dtype)
        if kind == 1:
            vals = np.repeat(vals, 32)[: max(rows, 1)]
        if kind == 2:
            vals[rng.random(vals.shape) < 0.3] = np.nan
    else:
        card = int(rng.choice([1, 2, 100, 100_000]))
        vals = rng.integers(0, card, max(rows, 1)).astype(dtype)
        if kind == 1:
            vals = np.sort(vals)
        elif kind == 2:
            vals = np.cumsum(rng.integers(0, 3, max(rows, 1))).astype(dtype)
    flat = _padded(vals, rows, dtype)
    plan, out = _roundtrip(flat, rows)
    if plan is not None:
        assert np.array_equal(_bits(out.reshape(-1)), _bits(flat)), (dtype, rows, plan)


def test_delta_nibble_picked_and_roundtrips():
    vals, rows = COLUMNS["nibble_i64"]
    flat = _padded(vals, rows, np.int64)
    plan, out = _roundtrip(flat, rows)
    assert plan is not None and plan.kind == "delta" and plan.delta_dtype == "nib"
    assert np.array_equal(out.reshape(-1), flat)
    u8 = codec.CodecPlan(kind="delta", dtype=plan.dtype, d=plan.d, shard_len=plan.shard_len,
                         delta_dtype=np.dtype(np.uint8).str, delta_off=plan.delta_off)
    assert plan.wire_nbytes() < 0.6 * u8.wire_nbytes()


@pytest.mark.parametrize("trial", range(25))
def test_delta_nibble_fuzz_bit_exact(trial):
    """Small-delta columns around any (negative too) frame offset, odd
    lengths included, through the nibble pack."""
    rng = np.random.default_rng(2300 + trial)
    total = NBLK * B
    rows = int(rng.integers(1, total + 1))
    lo = int(rng.integers(-1000, 1000))
    width = int(rng.integers(0, 16))
    deltas = rng.integers(lo, lo + width + 1, rows)
    base = int(rng.integers(-(1 << 40), 1 << 40))
    vals = base + np.concatenate([[0], np.cumsum(deltas[1:])]).astype(np.int64)
    flat = _padded(vals, rows, np.int64)
    plan, out = _roundtrip(flat, rows, min_ratio=1.01)
    if plan is not None and plan.kind == "delta":
        assert plan.delta_dtype == "nib"
        assert np.array_equal(out.reshape(-1), flat)


# -- the plain decodes at every dtype ---------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.int64, np.float32,
                                   np.float64])
def test_rle_plain_decode_every_dtype(dtype):
    """H18's plain version copies bits: every block dtype, NaN payloads and
    signed zeros of both float widths."""
    rng = np.random.default_rng(5)
    L, R = 1000, 37
    ends = np.sort(rng.choice(np.arange(1, L), R - 1, replace=False)).astype(np.int32)
    ends = np.append(ends, L).astype(np.int32)[None, :]
    if dtype == np.float64:
        raw = rng.integers(0, 1 << 63, R, dtype=np.uint64)
        raw[:4] = [0x7FF80000DEADBEEF, 0x7FF0000000000001, 1 << 63, 0]  # NaNs, -0.0, +0.0
        values = raw.view(np.float64)[None, :]
    elif dtype == np.float32:
        raw = rng.integers(0, 1 << 32, R, dtype=np.uint64).astype(np.uint32)
        raw[:4] = [0x7FC0DEAD, 0x7F800001, 0x80000000, 0]
        values = raw.view(np.float32)[None, :]
    else:
        values = rng.integers(0, np.iinfo(dtype).max, R).astype(dtype)[None, :]
    out = torch.zeros((1, L), dtype=codec.TORCH_DTYPES[np.dtype(dtype)])
    codec.rle_decode_plain(torch.from_numpy(values), torch.from_numpy(ends), out)
    want = values[0][np.minimum(np.searchsorted(ends[0], np.arange(L), side="right"), R - 1)]
    assert np.array_equal(_bits(out.numpy()[0]), _bits(want))


@pytest.mark.parametrize("out_dtype", [np.uint8, np.uint16, np.int32, np.int64])
@pytest.mark.parametrize("delta", ["nib", np.uint8, np.uint16, np.int8, np.int16, np.int32])
def test_delta_plain_decode_every_dtype(out_dtype, delta):
    """H19's plain version: exact wrapping int64 sums cast by their low
    bits, as numpy's astype, for every delta and block dtype, odd lengths
    and rows below the shard length included."""
    rng = np.random.default_rng(9)
    d, L = 3, 1001
    rows = np.array([L, 517, 0], np.int32)
    bases = rng.integers(-(1 << 62), 1 << 62, d)
    off = int(rng.integers(-(1 << 40), 1 << 40))
    if delta == "nib":
        dl = rng.integers(0, 16, (d, L)).astype(np.uint8)
        padded = np.concatenate([dl, np.zeros((d, 1), np.uint8)], axis=1)
        packed = (padded[:, 0::2] | (padded[:, 1::2] << 4))[:, : (L + 1) // 2]
    else:
        info = np.iinfo(delta)
        dl = rng.integers(info.min, info.max, (d, L)).astype(delta)
        packed = dl
    out = torch.zeros((d, L), dtype=codec.TORCH_DTYPES[np.dtype(out_dtype)])
    codec.delta_decode_plain(torch.from_numpy(bases), torch.from_numpy(packed),
                             torch.from_numpy(rows), off, delta == "nib", out)
    iota = np.arange(L)
    with np.errstate(over="ignore"):
        d64 = np.where((iota > 0) & (iota < rows[:, None]), dl.astype(np.int64) + off, 0)
        v = np.where(iota < rows[:, None], bases[:, None] + np.cumsum(d64, axis=1), 0)
    assert np.array_equal(out.numpy(), v.astype(out_dtype))


# H18 (ops/kernels/codec_kernels.cu) gives a CTA a tile of consecutive rows
# of one shard: warps 0 and 1 find the runs of its first and last row by a
# 32-ary search over the ends (with 256 runs or fewer it takes them all),
# the CTA stages those runs (at most the tile's rows + 1 of them), and each
# thread expands 16-byte slots of the output, a binary search of the staged
# ends for the slot's first run and a walk for the rest (a shard of 256 rows
# or fewer: a search a row); a row past a window that repeated ends cut
# short is searched in global memory, one past the last end takes run R - 1.
# The models below do the same in numpy at any tile, window and slot.
def _warp_upper_bound(e: np.ndarray, lo: int, hi: int, x: int) -> int:
    while hi > lo:
        step = (hi - lo + 31) // 32
        p = lo + (np.arange(32) + 1) * step - 1
        le = (p < hi) & (e[np.minimum(p, e.size - 1)] <= x)
        m = int(le.sum())
        hi = min(hi, lo + (m + 1) * step - 1)
        lo += m * step
    return lo


def _h18_tile_model(values: np.ndarray, ends: np.ndarray, L: int, tile: int, cap: int,
                    run: int) -> np.ndarray:
    """[d, L] decoded by H18's steps: ``tile`` rows a CTA, at most ``cap``
    staged runs, a search for each slot of ``run`` rows and a walk through
    it (a row a slot in a shard of 256 rows or fewer)."""
    run = 1 if L <= kernels.RLE_THREADS else run
    d, R = ends.shape
    out = np.zeros((d, L), values.dtype)
    writes = np.zeros((d, L), np.int64)
    for s in range(d):
        e, v = ends[s].astype(np.int64), values[s]
        for a in range(0, L, tile):
            b = min(L, a + tile)
            if R > kernels.RLE_THREADS:
                j0, j1 = _warp_upper_bound(e, 0, R, a), _warp_upper_bound(e, 0, R, b - 1)
            else:  # a run a thread or fewer: all staged, no search
                j0, j1 = 0, R
            w = min((j1 + 1 if j1 < R else R) - j0, cap)
            staged = e[j0:j0 + w]
            for r0 in range(a, b, run):  # a slot's rows
                c = int(np.searchsorted(staged, r0, side="right"))
                for r in range(r0, min(r0 + run, b)):
                    while c < w and staged[c] <= r:
                        c += 1
                    if c < w:
                        j = j0 + c
                    elif j0 + w >= R:
                        j = R - 1
                    else:
                        j = min(j0 + w + int(np.searchsorted(e[j0 + w:], r, side="right")), R - 1)
                    out[s, r] = v[j]
                    writes[s, r] += 1
    assert (writes == 1).all()  # every row written once, by one slot
    return out


def _ref_rle_decode(values: np.ndarray, ends: np.ndarray, L: int) -> np.ndarray:
    d, R = ends.shape
    plan = ref_codec.CodecPlan(kind="rle", dtype=values.dtype.str, d=d, shard_len=L, runs_cap=R)
    payload = ref_codec.CodecPayload(plan, (values, ends))
    mesh = _mesh(d)
    out = ref_codec.decoder(mesh, plan, 1, L)(*ref_codec.put_payload(mesh, payload))
    return np.asarray(out).reshape(d, L)


def _plain_rle_decode(values: np.ndarray, ends: np.ndarray, L: int) -> np.ndarray:
    out = torch.zeros((ends.shape[0], L), dtype=codec.TORCH_DTYPES[values.dtype])
    codec.rle_decode_plain(torch.from_numpy(values), torch.from_numpy(ends), out)
    return out.numpy()


def _rle_edge_case(name: str, dtype, rng):
    """(values [d, R], ends [d, R], L) of one edge of H18's contract."""
    L = 1001
    if name == "R1":
        ends = np.array([[L]], np.int32)
    elif name == "R1-rows-past-the-end":
        ends = np.array([[37]], np.int32)
    elif name == "repeated-padding-ends":
        ends = np.concatenate([np.sort(rng.choice(np.arange(1, L), 9, replace=False)), [L] * 23])
        ends = np.stack([ends, np.sort(rng.choice(np.arange(1, L), 32, replace=False))])
    elif name == "repeated-ends-inside":
        ends = np.sort(np.concatenate([[5] * 40, [6] * 3, [300] * 90, [L] * 2,
                                       rng.choice(np.arange(7, 300), 20, replace=False)]))[None]
    elif name == "rows-past-the-last-end":
        ends = np.stack([np.sort(rng.choice(np.arange(1, L - 100), 17, replace=False))
                         for _ in range(3)])
    else:
        raise ValueError(name)
    ends = ends.astype(np.int32)
    d, R = ends.shape
    w = np.dtype(dtype).itemsize
    raw = rng.integers(0, 1 << 63, (d, R), dtype=np.uint64)
    raw[0, :2] = [0x7FF80000DEADBEEF, 1 << 63][:2] if R > 1 else [0x7FF80000DEADBEEF]
    values = raw.view(np.uint8).reshape(d, R, 8)[:, :, :w].copy().view(dtype).reshape(d, R)
    return values, ends, L


RLE_EDGES = ["R1", "R1-rows-past-the-end", "repeated-padding-ends", "repeated-ends-inside",
             "rows-past-the-last-end"]


@pytest.mark.parametrize("dtype", [np.uint8, np.int64, np.float64])
@pytest.mark.parametrize("name", RLE_EDGES)
def test_rle_decode_edges_match_reference(name, dtype):
    """H18's contract at its edges (one run; runs of no rows at the end and
    inside a tile; rows past the last end, which take run R - 1): the plain
    decode and H18's tile model, at the kernel's tile and at small tiles and
    windows that repeated ends overflow, equal the reference's decoder bit
    for bit."""
    values, ends, L = _rle_edge_case(name, dtype, np.random.default_rng(len(name)))
    want = _ref_rle_decode(values, ends, L)
    assert np.array_equal(_bits(_plain_rle_decode(values, ends, L)), _bits(want))
    tile = kernels.rle_tile_rows(np.dtype(dtype).itemsize)
    for t, cap, run in ((tile, tile + 1, 16 // values.itemsize), (64, 65, 16), (64, 8, 8),
                        (7, 2, 3)):
        got = _h18_tile_model(values, ends, L, t, cap, run)
        assert np.array_equal(_bits(got), _bits(want)), (t, cap, run)


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("dtype", [np.int64, np.uint8])
def test_rle_at_the_codecs_short_run_limit(dtype, d):
    """The most runs the codec still ships as RLE (runs_cap * (w + 4) * 1.4
    <= L * w: about L / 2.3 rows a run for int64, L / 8 for uint8), every
    shard at the plan's cap less its slack: planned, encoded and decoded as
    the reference does, and by H18's tile model."""
    rng = np.random.default_rng(d)
    L, w = NBLK * B, np.dtype(dtype).itemsize
    c = int(L * w / (1.4 * (w + 4)))
    step = 1 << ((c - 1).bit_length() - 3)
    cap = (c // step) * step
    flat = np.empty((d, L), dtype)
    prev = None
    for s in range(d):
        cut = np.sort(rng.choice(np.arange(1, L), cap - 3, replace=False))
        run = np.searchsorted(cut, np.arange(L), side="right")
        if w == 1:  # neighbours differ
            vals = (np.cumsum(1 + rng.integers(0, 200, cap - 2)) % 251).astype(dtype)
        else:  # wide values: no delta encoding pays
            vals = rng.integers(0, 1 << 62, cap - 2).astype(dtype)
        if prev is not None:  # no change at a shard's edge: cap - 2 runs each
            vals[0] = prev
            vals[1] = prev + 1 if vals[1] == prev else vals[1]
        flat[s] = vals[run]
        prev = int(flat[s, -1])
    plan, out = _roundtrip(flat.reshape(-1), d * L, min_ratio=1.4, d=d)
    assert plan is not None and plan.kind == "rle" and plan.runs_cap == cap
    assert np.array_equal(out.reshape(-1), flat.reshape(-1))
    values, ends = codec.encode_window(flat.reshape(-1), plan, d * L).arrays
    tile = kernels.rle_tile_rows(w)
    got = _h18_tile_model(values, ends, L, tile, tile + 1, 16 // w)
    assert np.array_equal(got, flat)
    assert np.array_equal(_h18_tile_model(values, ends, L, 32, 33, 8), flat)


@pytest.mark.parametrize("seed", range(4))
def test_h18_warp_search_is_an_upper_bound(seed):
    """H18's 32-ary search of the ends (ballots over 32 evenly spaced ends a
    round) counts the ends at or below x in [lo, hi), repeated ends and x
    outside the ends included."""
    rng = np.random.default_rng(seed)
    e = np.sort(rng.integers(0, 5000, int(rng.integers(1, 70_000))))
    e[: e.size // 3] = np.sort(np.repeat(e[: e.size // 30 + 1], 10)[: e.size // 3])
    e = np.sort(e)
    for _ in range(200):
        lo = int(rng.integers(0, e.size))
        hi = int(rng.integers(lo, e.size + 1))
        x = int(rng.integers(-5, 5010))
        assert _warp_upper_bound(e, lo, hi, x) == lo + int(np.searchsorted(e[lo:hi], x, "right"))


@pytest.mark.parametrize("w, d, L, want", [(1, 1, 1 << 23, (2048, 4096)), (2, 3, 4097, (6, 4096)),
                                           (4, 1, 2048, (1, 2048)), (8, 4, 1 << 21, (4096, 2048)),
                                           (8, 2, 1, (2, 2048))])
def test_rle_decode_geometry(w, d, L, want):
    """H18's grid: a CTA a tile of each shard, 4096 rows of 1- and 2-byte
    blocks, 2048 of 4- and 8-byte ones, as codec_kernels.cu's RleTile."""
    import os

    assert kernels.codec_rle_decode_geometry(d, L, w) == (want[0], kernels.RLE_THREADS, 0)
    assert kernels.rle_tile_rows(w) == want[1]
    with open(os.path.join(os.path.dirname(kernels.__file__), "codec_kernels.cu")) as f:
        src = f.read()
    assert "kRows = sizeof(T) <= 2 ? 4096 : 2048;" in src
    assert f"constexpr int kRleThreads = {kernels.RLE_THREADS};" in src


# H19 (ops/kernels/codec_kernels.cu) decodes in three grids: each tile's sum
# of d64, an exclusive scan of the tile sums per shard (plus the shard's
# base), then a scan within each tile added to its prefix. The model below
# does the same in plain torch at any tile size.
def _tiled_delta_model(bases, dl, rows, off, tile, out_dtype):
    d, L = dl.shape
    iota = torch.arange(L)
    r = rows.to(torch.int64)[:, None]
    d64 = torch.where((iota > 0) & (iota < r), dl.to(torch.int64) + off, 0)
    tps = -(-L // tile)
    t = torch.nn.functional.pad(d64, (0, tps * tile - L)).reshape(d, tps, tile)
    sums = t.sum(dim=2)
    prefix = bases[:, None] + torch.cumsum(sums, dim=1) - sums
    v = (prefix[:, :, None] + torch.cumsum(t, dim=2)).reshape(d, -1)[:, :L]
    v = torch.where(iota < r, v, 0)
    return v.numpy().astype(out_dtype)


@pytest.mark.parametrize("out_dtype", [np.int64, np.uint16])
@pytest.mark.parametrize("rows_at", ["edge", "off_edge"])
@pytest.mark.parametrize("delta", ["nib", np.int16])
@pytest.mark.parametrize("tile", [1, 7, 4096])
def test_h19_tile_model_bit_exact(tile, delta, rows_at, out_dtype):
    """The tile decomposition equals the plain decode and the reference's
    decoder bit for bit over 3 shards of an odd length: rows on a tile edge
    and one row off it (0 and L too), an offset near +-2^40 and bases near
    +-2^63, so that the sums wrap at 2^64."""
    rng = np.random.default_rng(19)
    d, L = 3, 1001
    edge = (L // 2 // tile) * tile
    rows = np.array([edge, L, 0] if rows_at == "edge" else [max(edge - 1, 0), edge + 1, 1],
                    np.int32)
    bases = np.array([np.iinfo(np.int64).max - 5000, np.iinfo(np.int64).min + 3, 12345])
    off = (1 << 40) - 5 if out_dtype == np.int64 else -(1 << 40) + 3
    if delta == "nib":
        dl = rng.integers(0, 16, (d, L)).astype(np.uint8)
        padded = np.concatenate([dl, np.zeros((d, 1), np.uint8)], axis=1)
        packed = (padded[:, 0::2] | (padded[:, 1::2] << 4))[:, : (L + 1) // 2]
    else:
        dl = rng.integers(-(1 << 15), 1 << 15, (d, L)).astype(np.int16)
        packed = dl
    got = _tiled_delta_model(torch.from_numpy(bases), torch.from_numpy(dl),
                             torch.from_numpy(rows), off, tile, out_dtype)
    plain = torch.zeros((d, L), dtype=codec.TORCH_DTYPES[np.dtype(out_dtype)])
    codec.delta_decode_plain(torch.from_numpy(bases), torch.from_numpy(packed),
                             torch.from_numpy(rows), off, delta == "nib", plain)
    assert np.array_equal(got, plain.numpy())
    plan = ref_codec.CodecPlan(kind="delta", dtype=np.dtype(out_dtype).str, d=d, shard_len=L,
                               delta_dtype="nib" if delta == "nib" else np.dtype(delta).str,
                               delta_off=off)
    payload = ref_codec.CodecPayload(plan, (bases, packed, rows))
    mesh = _mesh(d)
    want = np.asarray(ref_codec.decoder(mesh, plan, 1, L)(*ref_codec.put_payload(mesh, payload)))
    assert np.array_equal(_bits(got), _bits(want.reshape(d, L)))


@pytest.mark.parametrize("d, L, want", [(1, 1 << 23, 2048), (3, 1_000_001, 3 * 245),
                                        (8, 1, 8), (3, 4096, 3), (3, 4097, 6)])
def test_delta_tiles(d, L, want):
    assert kernels.delta_tiles(d, L) == want


# -- the gid stream ----------------------------------------------------------------


def test_gid_stream_plans_and_roundtrips():
    """Sorted group keys give run-heavy gids: the stream plan encodes the gid
    lane as the reference's does, and the gids landed through the codec
    equal the raw ones."""
    rows = NBLK * B
    gids = np.sort(np.random.default_rng(31).integers(0, 4, rows)).astype(np.int32)
    cols = {"v": np.arange(rows, dtype=np.int64)}
    plan = staging.plan_stream(cols, rows, rows, block_rows=B, num_groups=4, has_gids=True,
                               gids=gids)
    want = ref_staging.plan_stream(_mesh(1), cols, rows, rows, block_rows=B, num_groups=4,
                                   has_gids=True, gids=gids)
    assert plan.gid_codec is not None
    assert plan.gid_codec == codec.CodecPlan(**want.gid_codec.__dict__)
    _rows, _packed, pgids, _n = staging.pack_stream_window(plan, cols, gids, 0)
    assert isinstance(pgids, codec.CodecPayload)
    assert pgids.nbytes < 0.2 * staging.staged_gid_nbytes(pgids)
    out = torch.empty((1, plan.nblk, plan.b), dtype=torch.uint8)
    staging.put_window_gids(pgids, out)
    assert np.array_equal(out.numpy().reshape(-1), gids.astype(np.uint8))


def test_gid_stream_random_gids_pass_through():
    rows = NBLK * B
    gids = np.random.default_rng(37).integers(0, 50_000, rows).astype(np.int32)
    cols = {"v": np.arange(rows, dtype=np.int64)}
    plan = staging.plan_stream(cols, rows, rows, block_rows=B, num_groups=50_000,
                               has_gids=True, gids=gids)
    assert plan.gid_codec is None
    _rows, _packed, pgids, _n = staging.pack_stream_window(plan, cols, gids, 0)
    assert isinstance(pgids, np.ndarray)


SORTED_Q = (
    "df = px.DataFrame(table='http_sorted')\n"
    "df.svc2 = df.service + df.service\n"
    "s = df.groupby(['svc2']).agg(\n"
    "    n=('time_', px.count),\n"
    "    total=('latency', px.sum),\n"
    "    status=('resp_status', px.sum),\n"
    ")\n"
    "px.display(s, 'out')\n"
)


def _sorted_data(n=12_000, seed=7) -> dict:
    rng = np.random.default_rng(seed)
    data = {
        "time_": np.arange(n) * 10**6,
        "service": rng.choice(["a", "b", "c"], n).astype(object),
        "resp_status": rng.choice([200, 400, 500], n),
        "latency": rng.exponential(30.0, n),
    }
    order = np.argsort(data["service"].astype(str), kind="stable")
    return {k: np.asarray(v)[order] for k, v in data.items()}


def _run_sorted(data, port: bool) -> dict:
    if port:
        c = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=256))
        rel = Relation.of(("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
                          ("service", DataType.STRING), ("resp_status", DataType.INT64),
                          ("latency", DataType.FLOAT64))
    else:
        c = RefCarnot(device_executor=MeshExecutor(mesh=_mesh(1), block_rows=256))
        rel = RefRelation.of(("time_", RefDT.TIME64NS, RefST.ST_TIME_NS),
                             ("service", RefDT.STRING), ("resp_status", RefDT.INT64),
                             ("latency", RefDT.FLOAT64))
    c.table_store.create_table("http_sorted", rel).write_pydict(dict(data))
    return c.execute_query(SORTED_Q).table("out")


@pytest.mark.parametrize("codec_on", [True, False])
def test_query_with_sorted_keys_gid_codec_bit_identical(codec_on):
    """A host-gids group-by over a key-sorted table (the gid lane and the
    time_ and status columns ride the codec): the port with the codec on
    equals the port with it off and the reference under the same flag, bit
    for bit."""
    data = _sorted_data()
    for f in (flags, ref_flags):
        f.set("staging_codec", codec_on)
    try:
        staging.reset_cold_profile()
        got = _run_sorted(data, port=True)
        prof = staging.reset_cold_profile()
        want = _run_sorted(data, port=False)
    finally:
        for f in (flags, ref_flags):
            f.reset("staging_codec")
    for f in (flags, ref_flags):
        f.set("staging_codec", False)
    try:
        off = _run_sorted(data, port=True)
    finally:
        for f in (flags, ref_flags):
            f.reset("staging_codec")
    assert set(got) == set(want) == set(off)
    for k in got:
        assert got[k] == off[k], k  # codec on == codec off, bit for bit
        if k == "total":  # f64 sums in another order than XLA's: H2's bound
            assert np.allclose(got[k], want[k], rtol=1e-12, atol=0), k
        else:
            assert got[k] == want[k], k
    if codec_on:  # the sorted gid lane (1 B a row, 16384 B padded) ships as a few runs
        assert prof["stage_bytes"] - prof["wire_bytes"] > 0.9 * 16384, prof
    else:
        assert prof["wire_bytes"] == prof["stage_bytes"], prof
    assert not any(kernels.LAUNCHES.values())
