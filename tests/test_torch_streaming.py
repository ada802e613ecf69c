"""The streamed cold path of the port (DeviceExecutor._stream_execute,
parallel/staging.py's StreamPlan, pack_stream_window and WindowStager)
against the port's monolithic staging and against the reference's streamed
path (pixie_tpu MeshExecutor on a one-device CPU mesh), on the same numpy
tables. Mirrors tests/test_streaming_stage.py.

Contracts. Stream against monolithic, in the port: counts, integer sums,
min/max and sketch cells exact; where the window is a multiple of the block
size the staged blocks are the monolithic ones and every output is
bit-equal; with a tail window that cuts blocks, f64 sums within 1e-12 of
sum |v| (H2's bound) and quantiles within the reference's own band
(5% at p50/p99). Port against reference, both streamed with the same flags
and geometry: counts, integer sums, max and count-min JSON exact, f64 sums
within 1e-12 relative, quantiles within one log bin (Fault-1).
"""

import collections
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import histogram, kernels, segment
from pixie_tpu_torch.parallel import DeviceExecutor, staging
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.utils import faults, flags

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

STATS_PXL = (
    "df = px.DataFrame(table='http_events')\n"
    "df.failure = df.resp_status >= 400\n"
    "stats = df.groupby(['service']).agg(\n"
    "    n=('time_', px.count),\n"
    "    total=('latency', px.sum),\n"
    "    err=('failure', px.mean),\n"
    "    hi=('latency', px.max),\n"
    "    st=('resp_status', px.sum),\n"
    "    q=('latency', px.quantiles),\n"
    ")\n"
    "px.display(stats, 'out')\n"
)
SKETCH_PXL = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    lat=('latency', px.quantiles_tdigest),\n"
    "    nd=('service', px.approx_count_distinct),\n"
    "    u=('resp_status', px.approx_count_distinct),\n"
    "    freq=('resp_status', px.count_min),\n"
    ")\n"
    "px.display(s, 'out')\n"
)
COUNT_PXL = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(n=('time_', px.count))\n"
    "px.display(s, 'out')\n"
)
BLOCK = 1024


def _data(n=10_000, seed=7) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n) * 10**6,
        "service": rng.choice(["a", "b", "c"], n, p=[0.5, 0.3, 0.2]).astype(object),
        "resp_status": rng.choice([200, 400, 500], n, p=[0.8, 0.1, 0.1]),
        "latency": rng.exponential(30.0, n),
    }


def _port(data: dict, block_rows: int = BLOCK):
    ex = DeviceExecutor(device="cpu", block_rows=block_rows)
    c = Carnot(device_executor=ex)
    rel = Relation.of(("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
                      ("service", DataType.STRING), ("resp_status", DataType.INT64),
                      ("latency", DataType.FLOAT64))
    t = c.table_store.create_table("http_events", rel)
    n = len(data["time_"])
    for off in range(0, n, 2048):
        t.write_pydict({k: v[off : off + 2048] for k, v in data.items()})
    return c, ex


def _ref(data: dict, block_rows: int = BLOCK):
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=block_rows)
    c = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS, RefST.ST_TIME_NS),
                         ("service", RefDT.STRING), ("resp_status", RefDT.INT64),
                         ("latency", RefDT.FLOAT64))
    t = c.table_store.create_table("http_events", rel)
    n = len(data["time_"])
    for off in range(0, n, 2048):
        t.write_pydict({k: v[off : off + 2048] for k, v in data.items()})
    return c, ex


class _flags:
    """Sets a flag in both packages, restored on exit."""

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


def _port_pair(data: dict, pxl: str, window_rows: int):
    """(streamed rows, monolithic rows, streamed executor, its lanes)."""
    with _flags(streaming_window_rows=window_rows):
        c, ex = _port(data)
        segment.reduce_lanes(reset=True)
        streamed = c.execute_query(pxl).table("out")
        lanes = segment.reduce_lanes(reset=True)
        with _flags(streaming_stage=False):
            cm, _ = _port(data)
            mono = cm.execute_query(pxl).table("out")
            assert segment.reduce_lanes(reset=True).get("stage_monolithic") == 1
    return streamed, mono, ex, lanes


def _by_service(rows: dict) -> dict:
    return {s: i for i, s in enumerate(rows["service"])}


def _abs_sums(data: dict) -> dict:
    return {s: float(np.abs(data["latency"][data["service"] == s]).sum()) for s in "abc"}


@pytest.mark.parametrize("window_rows", [BLOCK, 4 * BLOCK, 1 << 23])
def test_stream_window_of_whole_blocks_is_bit_equal(window_rows):
    """Windows that are a multiple of the block size (1, 4 blocks, and one
    window for the table) cut the monolithic blocks: every output, f64
    sums and quantiles included, is bit-equal."""
    data = _data()
    s, m, ex, lanes = _port_pair(data, STATS_PXL, window_rows)
    assert lanes.get("stage_stream") == 1 and "stage_monolithic" not in lanes
    assert s == m


def test_stream_tail_windows_match_monolithic():
    """10000 rows in 1000-row windows: every window ends mid-block. Counts,
    integer sums and max exact; f64 sums within 1e-12 sum|v|; quantiles in
    the reference's band."""
    data = _data()
    s, m, _ex, _l = _port_pair(data, STATS_PXL, 1000)
    ds, dm = _by_service(s), _by_service(m)
    assert set(ds) == set(dm) == {"a", "b", "c"}
    abs_sum = _abs_sums(data)
    for svc in "abc":
        i, j = ds[svc], dm[svc]
        assert s["n"][i] == m["n"][j] and s["st"][i] == m["st"][j] and s["hi"][i] == m["hi"][j]
        assert abs(s["total"][i] - m["total"][j]) <= 1e-12 * abs_sum[svc]
        assert s["err"][i] == pytest.approx(m["err"][j], rel=1e-12)
        q_s, q_m = json.loads(s["q"][i]), json.loads(m["q"][j])
        for key in ("p50", "p99"):
            assert q_s[key] == pytest.approx(q_m[key], rel=0.05)


@pytest.mark.parametrize("window_rows", [1000, BLOCK])
def test_stream_sketches_match_monolithic(window_rows):
    """HLL registers and count-min cells do not depend on the fold order:
    equal; the t-digest within the quantile band."""
    data = _data()
    s, m, _ex, _l = _port_pair(data, SKETCH_PXL, window_rows)
    ds, dm = _by_service(s), _by_service(m)
    for svc in "abc":
        i, j = ds[svc], dm[svc]
        assert s["nd"][i] == m["nd"][j] and s["u"][i] == m["u"][j]
        assert s["freq"][i] == m["freq"][j]
        assert json.loads(s["lat"][i])["p50"] == pytest.approx(
            json.loads(m["lat"][j])["p50"], rel=0.05)


def _within_a_bin(a: float, b: float) -> bool:
    return a == b or max(a, b) / min(a, b) <= histogram.DEFAULT_SPEC.gamma * (1 + 1e-9)


@pytest.mark.parametrize("window_rows", [1000, 4 * BLOCK])
def test_port_stream_matches_reference_stream_service_stats(window_rows):
    """service_stats-shaped query, both packages streamed with the same
    window and block sizes (a tail window, and windows of whole blocks)."""
    data = _data()
    with _flags(streaming_window_rows=window_rows):
        got = _port(data)[0].execute_query(STATS_PXL).table("out")
        rc, rex = _ref(data)
        want = rc.execute_query(STATS_PXL).table("out")
    assert not rex.stream_fallback_errors and not rex.fallback_errors
    assert got["service"] == want["service"]
    for k in ("n", "st", "hi"):
        assert got[k] == want[k], k
    assert np.allclose(got["total"], want["total"], rtol=1e-12, atol=0)
    assert np.allclose(got["err"], want["err"], rtol=1e-12, atol=0)
    for gq, wq in zip(got["q"], want["q"]):
        g, w = json.loads(gq), json.loads(wq)
        assert all(_within_a_bin(g[k], w[k]) for k in w)


@pytest.mark.parametrize("window_rows", [1000, 4 * BLOCK])
def test_port_stream_matches_reference_stream_sketches(window_rows):
    """config 5's UDAs plus HLL, streamed in both packages: the count-min
    JSON (through both cell lanes) and the distinct counts exact, the
    t-digest within its band."""
    data = _data()
    with _flags(streaming_window_rows=window_rows):
        got = _port(data)[0].execute_query(SKETCH_PXL).table("out")
        rc, rex = _ref(data)
        want = rc.execute_query(SKETCH_PXL).table("out")
    assert not rex.stream_fallback_errors
    assert got["service"] == want["service"]
    for k in ("nd", "u", "freq"):
        assert got[k] == want[k], k
    for gq, wq in zip(got["lat"], want["lat"]):
        assert json.loads(gq)["p50"] == pytest.approx(json.loads(wq)["p50"], rel=0.05)


def test_stream_non_multiple_and_tiny_tail():
    """2500 rows in 1000-row windows: 1000/1000/500; group counts exact."""
    data = _data(n=2500)
    with _flags(streaming_window_rows=1000):
        c, _ex = _port(data)
        staging.reset_cold_profile()
        rows = c.execute_query(COUNT_PXL).table("out")
        prof = staging.reset_cold_profile()
    assert prof["stream_windows"] == 3
    assert dict(zip(rows["service"], rows["n"])) == dict(
        collections.Counter(data["service"].tolist()))


def test_stream_populates_warm_cache():
    """The windows land in one staging that the warm query reads: no second
    stream, identical results, and a filter on a warm query sees every row
    once. The entry equals concat_stream_windows of the windows staged
    apart."""
    data = _data()
    with _flags(streaming_window_rows=1000):
        c, ex = _port(data)
        cold = c.execute_query(STATS_PXL).table("out")
        assert len(ex._staged_cache) == 1
        staging.reset_cold_profile()
        warm = c.execute_query(STATS_PXL).table("out")
        assert "stream_windows" not in staging.reset_cold_profile()
        assert warm == cold
        rows_f = c.execute_query(
            "df = px.DataFrame(table='http_events')\n"
            "df = df[df.resp_status >= 400]\n"
            "s = df.groupby(['service']).agg(n=('time_', px.count))\n"
            "px.display(s, 'out')\n"
        ).table("out")
    got = dict(zip(rows_f["service"], rows_f["n"]))
    for svc in "abc":
        assert got[svc] == int(((data["service"] == svc) & (data["resp_status"] >= 400)).sum())
    (entry,) = ex._staged_cache.values()
    assert entry.num_blocks == staging.bucket_block_count(10 * 1)  # ten windows of 1 block


def test_concat_stream_windows_equals_the_streamed_entry():
    """The preallocated staging the stream fills equals the named
    counterpart that concatenates per-window blocks and zero-pads to the
    bucket, block for block, mask and gids included."""
    rng = np.random.default_rng(3)
    n = 11_000
    cols = {"v": rng.integers(0, 1 << 40, n), "s": np.repeat(rng.integers(0, 5, n // 100 + 1),
                                                             100)[:n].astype(np.int64)}
    gids = np.sort(rng.integers(0, 300, n)).astype(np.int32)
    plan = staging.plan_stream(cols, n, 1000, block_rows=512, num_groups=300, has_gids=True,
                               gids=gids)
    assert plan.n_windows == 11 and plan.nblk == 2 and plan.codecs and plan.gid_codec
    stager = staging.WindowStager(plan, torch.device("cpu"))
    win_blocks, win_masks, win_gids = [], [], []
    for w in range(plan.n_windows):
        win = stager.pack(cols, gids, w)
        stager.put(win)
        blocks = {}
        for name, packed in win.packed.items():
            out = torch.empty((1, plan.nblk, plan.b),
                              dtype=stager.staged.blocks[name].dtype)
            staging.land(packed, out)
            blocks[name] = out
        g = torch.empty((1, plan.nblk, plan.b), dtype=stager.staged.gids.dtype)
        staging.put_window_gids(win.gids, g)
        win_blocks.append(blocks)
        win_masks.append(staging.build_mask(plan.nblk, plan.b, win.rows, "cpu"))
        win_gids.append(g)
    cat = staging.concat_stream_windows(plan, win_blocks, win_masks, win_gids)
    got = stager.staged
    assert got.num_blocks == cat.num_blocks == staging.bucket_block_count(22)
    assert torch.equal(got.mask, cat.mask) and torch.equal(got.gids, cat.gids)
    for name in cols:
        assert torch.equal(got.blocks[name], cat.blocks[name]), name
    # Every valid row is the column's row, window by window.
    v = got.blocks["v"].reshape(-1)[got.mask.reshape(-1)].to(torch.int64)
    assert np.array_equal(v.numpy() + plan.narrow_offsets.get("v", 0), cols["v"])


@pytest.mark.parametrize("n, window", [(4096, 1024), (4096 + 17, 1024), (3000, 4096)])
def test_stream_geometry_tiles_the_monolithic_blocks(n, window):
    """A window of whole blocks lands the monolithic staging's blocks (the
    same rows in the same blocks). A small table is one window clamped to
    its pow2-padded row count (the reference's signature bucket), which may
    hold more blocks than the monolithic staging's bucket: those are fully
    masked."""
    rng = np.random.default_rng(n)
    cols = {"x": rng.integers(0, 1 << 40, n), "y": rng.standard_normal(n)}
    plan = staging.plan_stream(dict(cols), n, window, block_rows=512)
    stager = staging.WindowStager(plan, torch.device("cpu"))
    for w in range(plan.n_windows):
        stager.put(stager.pack(cols, None, w))
    mono = staging.stage_columns(dict(cols), n, "cpu", block_rows=512)
    got = stager.staged
    k = mono.num_blocks
    assert got.block_rows == mono.block_rows == 512
    assert got.num_blocks == (8 if n == 3000 else k)
    assert torch.equal(got.mask[:, :k], mono.mask) and not got.mask[:, k:].any()
    for name in cols:
        assert torch.equal(got.blocks[name][:, :k], mono.blocks[name]), name


def test_stream_multipass_stays_monolithic():
    """A group-by that needs several passes re-scans the staged blocks: the
    stream's gate sends it to the monolithic staging, still on the device."""
    n, n_keys = 20_000, 10_000
    rng = np.random.default_rng(5)
    keys = rng.integers(0, n_keys, n)
    with _flags(streaming_window_rows=4096, device_group_state_budget_mb=1):
        ex = DeviceExecutor(device="cpu", block_rows=4096)
        c = Carnot(device_executor=ex)
        rel = Relation.of(("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
                          ("key", DataType.INT64), ("latency", DataType.FLOAT64))
        c.table_store.create_table("hc", rel).write_pydict(
            {"time_": np.arange(n), "key": keys, "latency": rng.exponential(30.0, n)})
        staging.reset_cold_profile()
        segment.reduce_lanes(reset=True)
        res = c.execute_query(
            "df = px.DataFrame(table='hc')\n"
            "s = df.groupby(['key']).agg(n=('time_', px.count), q=('latency', px.quantiles))\n"
            "px.display(s, 'out')\n"
        ).table("out")
        prof = staging.reset_cold_profile()
        lanes = segment.reduce_lanes(reset=True)
    assert "stream_windows" not in prof and lanes.get("stage_monolithic") == 1
    assert "stage_stream" not in lanes
    got = dict(zip(res["key"], res["n"]))
    assert got == dict(collections.Counter(keys.tolist()))


def test_stream_cold_profile_keys():
    """The cold breakdown carries the stream's keys (the reference's
    COLD_PROFILE names) and the window count."""
    data = _data()
    with _flags(streaming_window_rows=1024):
        c, _ex = _port(data)
        staging.reset_cold_profile()
        c.execute_query(STATS_PXL)
        prof = staging.reset_cold_profile()
    for key in ("stage_overlap", "stream_windows", "stage_stream_pack",
                "stage_stream_pack_wait", "stage_stream_put", "stage_stream_dispatch",
                "stage_stream_drain", "stage_encode", "stage_bytes", "wire_bytes"):
        assert key in prof, (key, sorted(prof))
    assert prof["stream_windows"] == 10  # ceil(10000 / 1024)
    # The service codes (0-2, diffs within 4) ship as nibble deltas.
    assert 0 < prof["wire_bytes"] < prof["stage_bytes"]
    assert not any(kernels.LAUNCHES.values())


def test_stream_pack_error_raises():
    """An error on the pack thread raises out of the query: the port never
    restages in one piece behind it, and no staging is cached."""
    data = _data()
    with _flags(streaming_window_rows=1024):
        c, ex = _port(data)
        faults.arm("staging.pack", count=1, after=3)
        try:
            with pytest.raises(faults.FaultInjectedError):
                c.execute_query(STATS_PXL)
        finally:
            faults.reset()
        assert not ex._staged_cache
        segment.reduce_lanes(reset=True)
        again = c.execute_query(STATS_PXL).table("out")  # the next query streams afresh
        assert segment.reduce_lanes(reset=True).get("stage_stream") == 1
    assert sum(again["n"]) == len(data["time_"])


def test_stream_codec_and_int_dict_recipes_are_the_reference_plans():
    """plan_stream fixes the same recipe as the reference's for config 5's
    columns: resp_status int-dict codes with the full column's LUT, the
    service codes narrowed, and the same codec plans."""
    from pixie_tpu.parallel import staging as ref_staging

    data = _data()
    cols = {"resp_status": data["resp_status"].astype(np.int64),
            "time_": data["time_"].astype(np.int64), "latency": data["latency"]}
    kw = dict(block_rows=BLOCK, f32_cols={"latency"}, cell_cols={"resp_status": 256})
    got = staging.plan_stream(cols, 10_000, 2048, **kw)
    want = ref_staging.plan_stream(Mesh(np.array(jax.devices()[:1]), ("d",)), cols, 10_000,
                                   2048, **kw)
    assert (got.window_rows, got.n_windows, got.nblk, got.b) == (
        want.window_rows, want.n_windows, want.nblk, want.b)
    assert got.block_dtypes == want.block_dtypes
    assert list(got.int_dicts["resp_status"]) == [200, 400, 500]
    assert {k: v.__dict__ for k, v in got.codecs.items()} == {
        k: v.__dict__ for k, v in want.codecs.items()}
    assert got.codecs["time_"].kind == "delta" and got.codecs["time_"].delta_dtype == "nib"
