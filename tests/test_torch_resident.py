"""Device-resident ingest in the port (serving/resident.py, the executor's
ResidencyPool in serving/residency.py, the raw -> plan converters of
ops/codec.py) against the reference (pixie_tpu MeshExecutor on a one-device
CPU mesh), on the same numpy tables. Mirrors the reference's ring tests
(tests/test_codec.py:423-590) and pool tests (tests/test_serving.py:111-190).

Sizes are the reference's ``_resident_engine``: 20,000 rows in 2048-row
appends, ``resident_window_rows`` 4096 (4 full ring windows, a 3616-row
tail), ``block_rows`` 512, seed 7.

Contracts. Port against reference, both ringed: ring windows, pool bytes,
hits (4 of 5 windows) and wire < stage / 3 equal; counts, groups, maxima,
distinct counts and the scan's rows exact; f64 sums within 1e-12 relative;
quantiles within one log bin (Fault-1). Port ringed against the port
unringed: bit-equal (the ring windows are whole blocks). The converters
(``convert_block_plain``) bit for bit against the port's host pack of the
same rows, NaN payloads, signed zeros and f32 subnormals included, and
against the reference's ``codec.convert_block`` but where the reference
flushes an f32-subnormal result to zero (Fault-15).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import codec as ref_codec
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.parallel.staging import reset_cold_profile as ref_reset_cold_profile
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.distributed import MeshConfig
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import codec, histogram, kernels, segment
from pixie_tpu_torch.ops.convert_edges import RING_CASES, SHARD_COUNTS, ring_case, strided_staging
from pixie_tpu_torch.parallel import DeviceExecutor, staging
from pixie_tpu_torch.serving import ResidencyPool, staged_nbytes
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.utils import faults, flags, metrics_registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

N, WINDOW, BLOCK, SEED = 20_000, 4096, 512, 7
NDEV = 4  # the logical CPU shards of a sharded ring
AGG_PXL = (
    "df = px.DataFrame(table='http_events')\n"
    "df.failure = df.resp_status >= 400\n"
    "stats = df.groupby(['service']).agg(\n"
    "    n=('time_', px.count),\n"
    "    total=('latency', px.sum),\n"
    "    hi=('latency', px.max),\n"
    "    err=('failure', px.mean),\n"
    "    q=('latency', px.quantiles),\n"
    "    u=('resp_status', px.approx_count_distinct),\n"
    ")\n"
    "px.display(stats, 'out')\n"
)
SCAN_PXL = (
    "df = px.DataFrame(table='http_events')\n"
    "df = df[df.resp_status >= 400]\n"
    "df = df[['time_', 'service', 'latency']]\n"
    "df = df.head(100000)\n"
    "px.display(df, 'out')\n"
)
# Every kind a plan stages: service codes narrowed, latency as f32 (the
# t-digest), resp_status as int-dictionary codes (count_min's cell lane),
# time_ raw (min).
KINDS_PXL = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    lat=('latency', px.quantiles_tdigest),\n"
    "    freq=('resp_status', px.count_min),\n"
    "    first=('time_', px.min),\n"
    ")\n"
    "px.display(s, 'out')\n"
)


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


def _ring_flags(**extra):
    # The reference derives a watchdog deadline from its cost model once
    # warm, which a loaded host can trip on a hosts axis: no watchdog.
    return _flags(resident_ingest=True, resident_window_rows=WINDOW,
                  mesh_dispatch_timeout_s=-1.0, **extra)


def _plain_flags():
    """The unringed engine's stream at the ring's window size: the same
    shard-major window layout, so its output is comparable bit for bit
    at any geometry (at d:1 the blocks are the same at any window)."""
    return _flags(streaming_window_rows=WINDOW)


def _data(n=N, seed=SEED) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n) * 10**6,
        "service": rng.choice(["a", "b", "c"], n).astype(object),
        "resp_status": rng.choice([200, 400, 500], n, p=[0.8, 0.1, 0.1]),
        "latency": rng.exponential(30.0, n),
    }


def _fill(t, data: dict) -> None:
    n = len(data["time_"])
    for off in range(0, n, 2048):
        t.write_pydict({k: v[off : off + 2048] for k, v in data.items()})
    t.compact()
    t.stop()


def _port(data: dict, spec: str = "d:1"):
    """(Carnot, its DeviceExecutor on the CPU, the table), built under the
    flags in force: with ``resident_ingest`` the table gets its ring,
    sharded over ``spec``'s 4 logical CPU shards (d:1: the CPU alone)."""
    if spec == "d:1":
        ex = DeviceExecutor(device="cpu", block_rows=BLOCK)
    else:
        ex = DeviceExecutor(block_rows=BLOCK, mesh_config=MeshConfig.parse(spec, NDEV),
                            devices=["cpu"] * NDEV)
    c = Carnot(device_executor=ex)
    rel = Relation.of(("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
                      ("service", DataType.STRING), ("resp_status", DataType.INT64),
                      ("latency", DataType.FLOAT64))
    t = c.table_store.create_table("http_events", rel)
    _fill(t, data)
    return c, c.device_executor, t


def _ref(data: dict, spec: str = "d:1"):
    cfg = MeshConfig.parse(spec, 1 if spec == "d:1" else NDEV)
    devs = np.array(jax.devices()[:cfg.total_devices]).reshape(cfg.shape)
    ex = MeshExecutor(mesh=Mesh(devs, cfg.names), block_rows=BLOCK)
    c = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS, RefST.ST_TIME_NS),
                         ("service", RefDT.STRING), ("resp_status", RefDT.INT64),
                         ("latency", RefDT.FLOAT64))
    t = c.table_store.create_table("http_events", rel)
    _fill(t, data)
    return c, ex, t


def _within_a_bin(a: float, b: float) -> bool:
    return a == b or max(a, b) / min(a, b) <= histogram.DEFAULT_SPEC.gamma * (1 + 1e-9)


def _assert_agg_matches_reference(got: dict, want: dict) -> None:
    assert got["service"] == want["service"]
    for k in ("n", "hi", "u"):
        assert got[k] == want[k], k
    assert np.allclose(got["total"], want["total"], rtol=1e-12, atol=0)
    assert np.allclose(got["err"], want["err"], rtol=1e-12, atol=0)
    for gq, wq in zip(got["q"], want["q"]):
        g, w = json.loads(gq), json.loads(wq)
        assert all(_within_a_bin(g[k], w[k]) for k in w)


# The ring's geometries: one device, and 4 logical CPU shards flat and with
# a hosts axis (the reference on 4 of its virtual CPU devices).
RING_SPECS = ("d:1", "d:4", "hosts:2,d:2")


@pytest.fixture(scope="module", params=RING_SPECS)
def ringed(request):
    """Both packages' ringed engines over one table on one geometry, and the
    port's unringed one on it: (data, port, reference, port without a
    ring)."""
    data = _data()
    with _ring_flags():
        port = _port(data, request.param)
        ref = _ref(data, request.param)
    plain = _port(data, request.param)
    return data, port, ref, plain


# -- the ring and the pool ------------------------------------------------------


def test_ring_windows_and_pool_accounting_match_reference(ringed):
    _data_, (c, ex, _t), (rc, rex, _rt), _plain = ringed
    snap = ex._resident.snapshot()["http_events"]
    ref_snap = rex._resident.snapshot()["http_events"]
    assert snap["windows"] == ref_snap["windows"] == 4  # 20000 rows / 4096
    assert snap["valid"] and ref_snap["valid"] and snap["last_error"] is None
    for k in ("window_rows", "resident_rows", "bytes", "buffered_rows"):
        assert snap[k] == ref_snap[k], k
    pool, ref_pool = ex._staged_cache.snapshot(), rex._staged_cache.snapshot()
    assert pool["resident_windows"] == ref_pool["resident_windows"] == 4
    # 4 windows x 4096 rows x (8 + 4 + 8 + 8) B.
    assert pool["resident_bytes"] == ref_pool["resident_bytes"] == 4 * 4096 * 28
    assert pool["pinned_bytes"] >= pool["resident_bytes"]
    ring = ex._resident.ring_for("http_events")
    assert ring.d == ex.mesh.size
    for w in ring.windows.values():
        assert {n: b.shape for n, b in w.blocks.items()} == {
            n: (ring.d, ring.nblk, ring.b) for n in ("time_", "service", "resp_status", "latency")}


def test_resident_windows_hold_the_raw_rows(ringed):
    """Every resident window is the raw rows of its span, bit for bit (the
    codec's decodes included)."""
    data, (c, ex, t), _ref_, _plain = ringed
    ring = ex._resident.ring_for("http_events")
    codes = staging.read_columns(t, ["service"])[0]["service"]
    for k, w in ring.windows.items():
        sl = slice(k * WINDOW, (k + 1) * WINDOW)
        assert np.array_equal(w.blocks["time_"].reshape(-1).numpy(), data["time_"][sl])
        assert np.array_equal(w.blocks["service"].reshape(-1).numpy(), codes[sl])
        assert np.array_equal(w.blocks["resp_status"].reshape(-1).numpy(), data["resp_status"][sl])
        assert np.array_equal(w.blocks["latency"].reshape(-1).numpy().view(np.uint64),
                              data["latency"][sl].view(np.uint64))


def test_resident_ingest_hot_table_stages_only_tail(ringed):
    """4 of 5 stream windows come from the ring in both packages; the wire
    carries the tail only; results match the reference's ringed engine and
    equal the port's unringed engine bit for bit."""
    data, (c, ex, _t), (rc, rex, _rt), (pc, _pex, _pt) = ringed
    ex.clear_caches()
    with _ring_flags():
        staging.reset_cold_profile()
        segment.reduce_lanes(reset=True)
        got = c.execute_query(AGG_PXL).table("out")
        prof = staging.reset_cold_profile()
        lanes = segment.reduce_lanes(reset=True)
        ref_reset_cold_profile()
        want = rc.execute_query(AGG_PXL).table("out")
        ref_prof = ref_reset_cold_profile()
    assert prof.get("stage_resident_hits") == ref_prof.get("stage_resident_hits") == 4.0
    assert prof["wire_bytes"] < prof["stage_bytes"] / 3.0, prof
    assert ref_prof["wire_bytes"] < ref_prof["stage_bytes"] / 3.0, ref_prof
    assert prof["stage_bytes"] == ref_prof["stage_bytes"]
    assert prof["stream_windows"] == 5 and lanes.get("stage_stream") == 1
    # service codes narrowed, resp_status narrowed, latency identity: per hit.
    assert lanes.get("convert_narrow") == 8 and lanes.get("convert_identity") == 4, lanes
    assert not rex.stream_fallback_errors
    _assert_agg_matches_reference(got, want)
    with _plain_flags():
        assert got == pc.execute_query(AGG_PXL).table("out")


def test_resident_scan_row_set_and_warm_cache(ringed):
    """The scan assembles its staging from the ring plus the staged tail:
    the same rows as the reference's and numpy's; the warm query reads the
    cache and copies nothing."""
    data, (c, ex, _t), (rc, _rex, _rt), _plain = ringed
    ex.clear_caches()
    with _ring_flags():
        staging.reset_cold_profile()
        segment.reduce_lanes(reset=True)
        got = c.execute_query(SCAN_PXL).table("out")
        prof = staging.reset_cold_profile()
        lanes = segment.reduce_lanes(reset=True)
        want = rc.execute_query(SCAN_PXL).table("out")
        warm = c.execute_query(SCAN_PXL).table("out")
        prof2 = staging.reset_cold_profile()
    assert prof.get("stage_resident_hits") == 4.0, prof
    assert prof["wire_bytes"] < prof["stage_bytes"] / 3.0, prof
    assert lanes.get("stage_resident") == 1
    assert prof2.get("wire_bytes", 0.0) == 0.0, prof2
    sel = data["resp_status"] >= 400
    order = np.arange(N)
    if ex.mesh.size > 1:
        # The ring's staging is shard-major a window (shard s holds each
        # window's rows from s * W / D), and the scan takes the shards in
        # device order, as the reference's ringed scan does.
        span = WINDOW // ex.mesh.size
        order = np.concatenate([
            np.arange(w * WINDOW + s * span, w * WINDOW + (s + 1) * span)
            for s in range(ex.mesh.size) for w in range(-(-N // WINDOW))
        ])
        order = order[order < N]
        assert got == want
    sel_rows = order[sel[order]]
    assert np.array_equal(np.asarray(got["time_"]), data["time_"][sel_rows])
    assert list(got["service"]) == list(data["service"][sel_rows])
    assert np.asarray(got["latency"]).view(np.uint64).tolist() == \
        data["latency"][sel_rows].view(np.uint64).tolist()
    assert sorted(np.asarray(want["time_"]).tolist()) == sorted(np.asarray(got["time_"]).tolist())
    assert warm == got


def test_every_staged_kind_converts_from_the_ring(ringed):
    """narrow (service codes), f32 (the t-digest's latency), intdict
    (count_min's cell lane over resp_status) and a raw identity (time_):
    each converted on its hit windows; results equal the port unringed bit
    for bit and the reference's ringed engine under its contracts."""
    _data_, (c, ex, _t), (rc, _rex, _rt), (pc, _pex, _pt) = ringed
    ex.clear_caches()
    with _ring_flags():
        segment.reduce_lanes(reset=True)
        staging.reset_cold_profile()
        got = c.execute_query(KINDS_PXL).table("out")
        prof = staging.reset_cold_profile()
        lanes = segment.reduce_lanes(reset=True)
        want = rc.execute_query(KINDS_PXL).table("out")
    assert prof.get("stage_resident_hits") == 4.0
    for kind in ("narrow", "f32", "intdict", "identity"):
        assert lanes.get(f"convert_{kind}") == 4, lanes
    assert lanes.get("cell_lane") == 1
    with _plain_flags():
        assert got == pc.execute_query(KINDS_PXL).table("out")
    assert got["service"] == want["service"]
    assert got["freq"] == want["freq"] and got["first"] == want["first"]
    for gq, wq in zip(got["lat"], want["lat"]):
        assert json.loads(gq)["p50"] == pytest.approx(json.loads(wq)["p50"], rel=0.05)


def test_time_bounded_query_skips_resident(ringed):
    data, (c, ex, _t), (rc, _rex, _rt), _plain = ringed
    pxl = (
        "df = px.DataFrame(table='http_events', start_time=0, "
        f"end_time={int(data['time_'][5000])})\n"
        "s = df.groupby(['service']).agg(n=('time_', px.count))\n"
        "px.display(s, 'out')\n"
    )
    ex.clear_caches()
    with _ring_flags():
        staging.reset_cold_profile()
        got = c.execute_query(pxl).table("out")
        prof = staging.reset_cold_profile()
        ref_reset_cold_profile()
        want = rc.execute_query(pxl).table("out")
        ref_prof = ref_reset_cold_profile()
    assert prof.get("stage_resident_hits", 0.0) == ref_prof.get("stage_resident_hits", 0.0) == 0.0
    assert int(np.asarray(got["n"]).sum()) == 5001
    assert got == want


def _lane_numpy(lane) -> np.ndarray:
    """A ring window's [D, nblk, b] lane as numpy (a ShardedBlocks' parts
    stacked in shard order)."""
    if isinstance(lane, staging.ShardedBlocks):
        return np.concatenate([p.numpy() for p in lane.parts])
    return lane.numpy()


def test_ring_windows_equal_the_references_shard_by_shard(ringed):
    """Every staged window, each column and each shard, equals the
    reference's ``ResidentRing.windows[k].blocks[name]`` bit for bit."""
    _data_, (_c, ex, _t), (_rc, rex, _rt), _plain = ringed
    ring = ex._resident.ring_for("http_events")
    ref_ring = rex._resident.ring_for("http_events")
    assert (ring.d, ring.nblk, ring.b) == (ref_ring.d, ref_ring.nblk, ref_ring.b)
    assert sorted(ring.windows) == sorted(ref_ring.windows) == [0, 1, 2, 3]
    for k, w in ring.windows.items():
        rw = ref_ring.windows[k]
        assert (w.start_row, w.rows, w.nbytes) == (rw.start_row, rw.rows, rw.nbytes)
        for name, lane in w.blocks.items():
            got, want = _lane_numpy(lane), np.asarray(rw.blocks[name])
            assert got.shape == want.shape == (ring.d, ring.nblk, ring.b)
            assert got.dtype == want.dtype, name
            for s in range(ring.d):
                assert np.array_equal(_bits(got[s]), _bits(want[s])), (k, name, s)


def test_degraded_rung_serves_no_ring_window():
    """On a rung below the full geometry the ring serves nothing (its
    windows are sharded on the full mesh, as the reference's are): the
    fold stages from the host and equals the unringed engine's; once the
    full rung is back, the ring serves again."""
    data = _data()
    with _ring_flags():
        c, ex, _t = _port(data, "hosts:2,d:2")
    plain = _port(data, "hosts:2,d:2")[0]
    full = ex.mesh_config.signature()
    with _plain_flags():
        want = plain.execute_query(AGG_PXL).table("out")
    with _ring_flags(mesh_breaker_threshold=1, mesh_breaker_cooldown_s=3600.0,
                     streaming_window_rows=WINDOW):
        ex._geom_breaker_record(full, ok=False)  # the full rung's breaker opens
        staging.reset_cold_profile()
        got = c.execute_query(AGG_PXL).table("out")
        prof = staging.reset_cold_profile()
        assert ex.mesh_recovery_snapshot()["geometry"] == "d:4"
        assert ex._resident_ring(_t, types.SimpleNamespace(
            table_name="http_events", start_time=None, stop_time=None)) is None
        assert prof.get("stage_resident_hits", 0.0) == 0.0, prof
        ex._geom_breaker.clear()
        ex.clear_caches()
        staging.reset_cold_profile()
        again = c.execute_query(AGG_PXL).table("out")
        assert staging.reset_cold_profile().get("stage_resident_hits") == 4.0
        assert ex.mesh_recovery_snapshot()["geometry"] == full
    assert got == want and again == want


def test_clear_caches_keeps_the_ring(ringed):
    _data_, (c, ex, _t), _ref_, _plain = ringed
    with _ring_flags():
        c.execute_query(AGG_PXL)
    assert len(ex._staged_cache) >= 1
    before = ex._staged_cache.snapshot()
    ex.clear_caches()
    after = ex._staged_cache.snapshot()
    assert len(ex._staged_cache) == 0 and after["entries"] == 0
    assert after["resident_windows"] == before["resident_windows"] == 4
    assert after["resident_bytes"] == after["used_bytes"] == before["resident_bytes"]
    assert ex._resident.snapshot()["http_events"]["windows"] == 4


def test_resident_ring_rolls_and_releases_accounting():
    data = _data()
    with _ring_flags(resident_max_windows=2):
        c, ex, _t = _port(data)
        rc, rex, _rt = _ref(data)
    for e in (ex, rex):
        assert e._resident.snapshot()["http_events"]["windows"] == 2  # rolled 4 -> 2
        assert e._staged_cache.snapshot()["resident_windows"] == 2
    ring = ex._resident.ring_for("http_events")
    assert sorted(ring.windows) == sorted(rex._resident.ring_for("http_events").windows) == [2, 3]
    with _ring_flags():
        staging.reset_cold_profile()
        got = c.execute_query(AGG_PXL).table("out")
        assert staging.reset_cold_profile().get("stage_resident_hits") == 2.0
    ring.release_all()
    pool = ex._staged_cache.snapshot()
    assert pool["resident_windows"] == 0 and pool["resident_bytes"] == 0
    assert pool["pinned_bytes"] == 0
    with _ring_flags():
        assert got == c.execute_query(AGG_PXL).table("out")


class _FakeBatch:
    num_rows = 5


def test_resident_ring_invalidates_on_row_gap():
    data = _data()
    with _ring_flags():
        c, ex, _t = _port(data)
        rc, rex, _rt = _ref(data)
    for e in (ex, rex):
        ring = e._resident.ring_for("http_events")
        # A listener that missed rows: the ring disables itself and frees its
        # windows; it never serves stale ones.
        ring.on_append(ring._next_row + 5, _FakeBatch())
        assert not ring._valid
        assert e._staged_cache.snapshot()["resident_windows"] == 0
    with _ring_flags():
        staging.reset_cold_profile()
        got = c.execute_query(AGG_PXL).table("out")
        assert staging.reset_cold_profile().get("stage_resident_hits", 0.0) == 0.0
        want = rc.execute_query(AGG_PXL).table("out")
    assert len(got["n"]) == 3 and sum(got["n"]) == N
    _assert_agg_matches_reference(got, want)


def test_ring_invalidates_on_dtype_mismatch():
    """A batch whose column dtype is not the raw dtype invalidates the ring."""
    with _ring_flags():
        c, ex, _t = _port(_data(n=100))
    ring = ex._resident.ring_for("http_events")
    batch = types.SimpleNamespace(
        num_rows=1, col=lambda name: np.zeros(1, np.int32 if name != "service" else np.int64))
    ring.on_append(ring._next_row, batch)
    assert not ring.snapshot()["valid"]


def test_failed_window_staging_invalidates_the_ring(monkeypatch):
    """Staging runs on the writer's thread and the table only logs a failing
    listener: the ring records the failure (invalid, ``last_error``) and
    holds no window; queries stage from the host and stay right."""
    def boom(*a, **k):
        raise RuntimeError("staging failed on purpose")

    monkeypatch.setattr(codec, "plan_codec_local", boom)
    data = _data()
    with _ring_flags():
        c, ex, _t = _port(data)
    snap = ex._resident.snapshot()["http_events"]
    assert not snap["valid"] and snap["windows"] == 0
    assert snap["last_error"] == "RuntimeError: staging failed on purpose"
    assert ex._staged_cache.snapshot()["resident_bytes"] == 0
    monkeypatch.undo()
    plain = _port(data)[0]
    with _ring_flags():
        staging.reset_cold_profile()
        got = c.execute_query(AGG_PXL).table("out")
        assert staging.reset_cold_profile().get("stage_resident_hits", 0.0) == 0.0
    assert got == plain.execute_query(AGG_PXL).table("out")


@pytest.mark.parametrize("flag_values", [
    {"durable_resident": True, "wal_dir": "spill"},
    {"ring_replication_factor": 2},
], ids=["durable_resident", "ring_replication"])
def test_unported_ring_flags_raise(flag_values, tmp_path):
    if "wal_dir" in flag_values:
        flag_values = dict(flag_values, wal_dir=str(tmp_path))
    with _ring_flags():
        for k, v in flag_values.items():
            flags.set(k, v)
        try:
            c = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=BLOCK))
            rel = Relation.of(("time_", DataType.TIME64NS), ("v", DataType.FLOAT64))
            with pytest.raises(NotImplementedError, match="not ported yet"):
                c.table_store.create_table("t", rel)
            with pytest.raises(NotImplementedError, match="not ported yet"):
                c.device_executor.enable_resident_ingest(c.table_store.get_table("t"))
        finally:
            for k in flag_values:
                flags.reset(k)


def test_ring_off_by_default():
    c, ex, _t = _port(_data(n=5000))
    assert ex._resident is None
    assert ex.enable_resident_ingest(_t) is None


# -- the converters (K8) ------------------------------------------------------------

_F64_EDGES = np.array([
    0x7FF8000000000000, 0xFFF8000000000000, 0x7FF80000DEADBEEF, 0x7FF4000000000001,
    0xFFF0000000000001, 0x7FF0000000000000, 0xFFF0000000000000, 0x0000000000000000,
    0x8000000000000000, 0x36A0000000000000, 0x3690000000000000, 0xB6A8000000000000,
    0x3810000000000000, 0x380FFFFFFFFFFFFF, 0x47EFFFFFE0000000, 0x47EFFFFFF0000000,
    0x4800000000000000, 0x7FEFFFFFFFFFFFFF, 0x0000000000000001, 0x3FF0000010000000,
], dtype=np.uint64)


def _f64_inputs(rng, n):
    """Normal values with every f32 edge: NaN payloads of both signs (quiet
    and signalling), +-inf, +-0, values in the f32 subnormal range and below
    it, rounding ties, values that overflow f32."""
    x = rng.exponential(3e7, n)
    x[: _F64_EDGES.size] = _F64_EDGES.view(np.float64)
    x[_F64_EDGES.size : 2 * _F64_EDGES.size] = -_F64_EDGES.view(np.float64)
    return x


def _converter_case(case: str, n: int):
    """(raw numpy column, col_plan, plan block dtype) of one kernel-phase
    case."""
    rng = np.random.default_rng(8)
    if case == "narrow_i32_u8":
        return rng.integers(0, 16, n).astype(np.int32), ("narrow", (np.dtype(np.uint8), 0)), np.uint8
    if case == "narrow_i32_u16":
        a = rng.integers(-70, 60000, n).astype(np.int32)
        return a, ("narrow", (np.dtype(np.uint16), -70)), np.uint16
    if case == "narrow_i64_u16":
        a = rng.choice([200, 404, 500, 300 + 65535 - 100], n).astype(np.int64)
        return a, ("narrow", (np.dtype(np.uint16), 200)), np.uint16
    if case == "narrow_i64_u8":
        a = rng.integers(1 << 40, (1 << 40) + 256, n).astype(np.int64)
        return a, ("narrow", (np.dtype(np.uint8), 1 << 40)), np.uint8
    if case == "narrow_i64_i32":
        a = rng.integers(-(1 << 40), -(1 << 40) + (1 << 31) - 1, n).astype(np.int64)
        return a, ("narrow", (np.dtype(np.int32), -(1 << 40))), np.int32
    if case == "f32":
        return _f64_inputs(rng, n), ("f32", None), np.float32
    if case.startswith("intdict"):
        C = {"intdict_c3": 3, "intdict_c256": 256, "intdict_c257": 257,
             "intdict_c65536": 1 << 16}[case]
        lut = np.unique(rng.integers(-(1 << 50), 1 << 50, C + 64))[:C].astype(np.int64)
        a = lut[rng.integers(0, C, n)]
        dt = np.dtype(np.uint8 if C <= 256 else np.uint16)
        return a, ("intdict", (lut, dt)), dt
    if case == "raw_i64":
        return rng.integers(-(1 << 62), 1 << 62, n), ("raw", None), np.int64
    if case == "raw_f64":
        return _f64_inputs(rng, n), ("raw", None), np.float64
    if case == "raw_bool":
        return rng.random(n) < 0.5, ("raw", None), np.bool_
    if case == "raw_i64_i32":  # a raw cast: the low 4 bytes
        return rng.integers(-(1 << 62), 1 << 62, n), ("raw", None), np.int32
    if case == "raw_i32_u8":
        return rng.integers(-300, 300, n).astype(np.int32), ("raw", None), np.uint8
    raise AssertionError(case)


CONVERT_CASES = [
    "narrow_i32_u8", "narrow_i32_u16", "narrow_i64_u16", "narrow_i64_u8", "narrow_i64_i32",
    "f32", "intdict_c3", "intdict_c256", "intdict_c257", "intdict_c65536",
    "raw_i64", "raw_f64", "raw_bool", "raw_i64_i32", "raw_i32_u8",
]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("case", CONVERT_CASES)
def test_convert_block_plain_matches_reference_and_host_pack(case):
    """One ring window's block ([1, nblk, b], 4096 rows in 512-row blocks):
    ``convert_block`` on the CPU (``convert_block_plain``) against the
    reference's jitted converter and against the port's host pack of the
    same rows, bit for bit."""
    nblk, b = 8, 512
    n = nblk * b
    raw, col_plan, dt = _converter_case(case, n)
    raw_t = torch.from_numpy(raw.reshape(1, nblk, b).copy())
    with np.errstate(all="ignore"):
        got = codec.convert_block(col_plan, raw_t, int_dtype=dt).numpy()
        mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
        want = np.asarray(ref_codec.convert_block(
            mesh, col_plan, jnp.asarray(raw.reshape(1, nblk, b)), int_dtype=np.dtype(dt)))
        plan = staging.StreamPlan(
            col_plans={"c": col_plan}, narrow_offsets={}, int_dicts={},
            block_dtypes={"c": np.dtype(dt)}, window_rows=n, num_rows=n, n_windows=1, d=1,
            nblk=nblk, b=b, gid_dtype=None, num_groups=1,
        )
        host = None
        if col_plan[0] != "raw":  # the host pack only transforms the other kinds
            host = staging.pack_stream_window(plan, {"c": raw}, None, 0)[1]["c"]
    assert got.dtype == want.dtype == np.dtype(dt)
    keep = np.ones(got.shape, dtype=bool)
    if case == "f32":
        keep = ~_f32_subnormal(got)  # Fault-15: the reference flushes them
    assert np.array_equal(_bits(got)[keep], _bits(want)[keep]), case
    if host is not None:
        assert np.array_equal(_bits(got), _bits(np.asarray(host))), case


def _f32_subnormal(a: np.ndarray) -> np.ndarray:
    return (a != 0) & (np.abs(a) < np.float32(2.0 ** -126))


def test_fault15_reference_converter_flushes_f32_subnormals():
    """Fault-15: the reference's jitted f64 -> f32 converter (XLA-CPU)
    flushes an f32-subnormal result to a zero of its sign, where the host
    pack (numpy) keeps it. The port keeps it, bit for bit the host pack, on
    the CPU and on the card (H24); every other value, NaN payloads
    included, equals the reference's."""
    raw, col_plan, _dt = _converter_case("f32", 4096)
    with np.errstate(all="ignore"):
        host = raw.astype(np.float32).reshape(1, 8, 512)
    got = codec.convert_block(col_plan, torch.from_numpy(raw.reshape(1, 8, 512).copy())).numpy()
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    want = np.asarray(ref_codec.convert_block(mesh, col_plan, jnp.asarray(raw.reshape(1, 8, 512))))
    sub = _f32_subnormal(host)
    assert sub.sum() == 4  # +-2^-149, +-1.5 * 2^-149 of the edge values
    assert np.array_equal(_bits(got), _bits(host))
    assert np.all(want[sub] == 0) and np.array_equal(np.signbit(want[sub]), np.signbit(host[sub]))
    assert np.array_equal(_bits(want)[~sub], _bits(host)[~sub])


@pytest.mark.parametrize("d", SHARD_COUNTS)
@pytest.mark.parametrize("case", RING_CASES)
def test_convert_block_plain_lands_d_shards_in_a_strided_slice(case, d):
    """A ring window of ``d`` shards ([d, nblk, b]) converted into its slice
    of a one-card staging of three windows (d runs at the staging's shard
    stride): each shard equals the reference's converter on its ``d``-device
    mesh and the host pack of its rows, bit for bit (but where the reference
    flushes an f32 subnormal, Fault-15); the other windows keep their
    bytes."""
    nblk, b = 2, 512
    raw, col_plan, dt, _off = ring_case(case, np.random.default_rng(30 + d), d * nblk * b)
    tdt = codec.TORCH_DTYPES[dt]
    staged, out = strided_staging(d, nblk, b, tdt, "cpu")
    untouched = staged.clone()
    int_dtype = dt if col_plan[0] == "raw" else None
    assert kernels.ring_convert_shards(torch.from_numpy(raw.reshape(d, nblk, b)), out) == (
        (1, nblk * b, nblk * b, nblk * b) if d == 1 else (d, nblk * b, nblk * b, 3 * nblk * b))
    got = codec.convert_block(col_plan, torch.from_numpy(raw.reshape(d, nblk, b)), out=out,
                              int_dtype=int_dtype)
    assert got is out
    got = got.numpy()
    mesh = Mesh(np.array(jax.devices()[:d]), ("d",))
    with np.errstate(all="ignore"):
        want = np.asarray(ref_codec.convert_block(
            mesh, col_plan, jnp.asarray(raw.reshape(d, nblk, b)), int_dtype=np.dtype(dt)))
        host = raw.astype(dt) if col_plan[0] == "raw" else np.asarray(staging.pack_stream_window(
            staging.StreamPlan(
                col_plans={"c": col_plan}, narrow_offsets={}, int_dicts={},
                block_dtypes={"c": dt}, window_rows=d * nblk * b, num_rows=d * nblk * b,
                n_windows=1, d=d, nblk=nblk, b=b, gid_dtype=None, num_groups=1,
            ), {"c": raw}, None, 0)[1]["c"])
    keep = ~_f32_subnormal(got) if case == "f32" else np.ones(got.shape, dtype=bool)
    for s_ in range(d):
        assert np.array_equal(_bits(got[s_])[keep[s_]], _bits(want[s_])[keep[s_]]), (case, s_)
    assert np.array_equal(_bits(got.reshape(-1)), _bits(host.reshape(-1))), case
    for w in (0, 2):
        sl = slice(w * nblk, (w + 1) * nblk)
        assert torch.equal(staged[:, sl].contiguous().view(torch.uint8),
                           untouched[:, sl].contiguous().view(torch.uint8))


def test_ring_convert_shards_reads_the_strided_layouts():
    a = torch.zeros((4, 2, 8), dtype=torch.int64)
    big = torch.zeros((4, 6, 8), dtype=torch.uint16)
    assert kernels.ring_convert_shards(a, big[:, 2:4]) == (4, 16, 16, 48)
    assert kernels.ring_convert_shards(a, torch.empty((4, 2, 8), dtype=torch.uint16)) == (
        1, 64, 64, 64)
    assert kernels.ring_convert_shards(big[:, 0:2], a) == (4, 16, 48, 16)
    with pytest.raises(ValueError):  # a shard not one run
        kernels.ring_convert_shards(a, torch.zeros((4, 8, 2), dtype=torch.uint16).transpose(1, 2))
    with pytest.raises(ValueError):  # other shard counts
        kernels.ring_convert_shards(a.reshape(2, 4, 8), big[:, 2:4])
    with pytest.raises(ValueError):  # element counts differ
        kernels.ring_convert_shards(a, big[:, 2:5])


def test_convert_block_writes_into_a_staging_slice():
    """``out`` is the window's slice of a preallocated staging: the block
    lands there with no other window touched."""
    raw, col_plan, dt = _converter_case("narrow_i64_u16", 4 * 512)
    staged = torch.full((1, 12, 512), 7, dtype=torch.uint16)
    out = staged[:, 4:8]
    assert codec.convert_block(col_plan, torch.from_numpy(raw.reshape(1, 4, 512)), out=out) is out
    assert torch.equal(staged[:, :4].to(torch.int32), torch.full((1, 4, 512), 7, dtype=torch.int32))
    assert np.array_equal(out.reshape(-1).numpy(), (raw - 200).astype(np.uint16))
    with pytest.raises(ValueError):
        codec.convert_block(col_plan, torch.from_numpy(raw.reshape(1, 4, 512)),
                            out=torch.empty((1, 4, 512), dtype=torch.uint8))


def test_f32_conversion_keeps_nan_payloads_as_the_host_casts():
    """A NaN keeps its sign and the top 23 payload bits, quieted, as numpy
    casts it; subnormals and overflow as numpy casts them."""
    x = _f64_inputs(np.random.default_rng(1), 64)
    with np.errstate(all="ignore"):
        want = x.astype(np.float32).view(np.uint32)
    got = codec.convert_block(("f32", None), torch.from_numpy(x)).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert want[2] == 0x7FC00006 and want[3] == 0x7FE00000  # payload kept, quieted
    assert want[9] == 1  # 2^-149, the smallest f32 subnormal


def test_pack_stream_window_skip_cols_packs_only_gids():
    data = {"a": np.arange(3000, dtype=np.int64), "b": np.linspace(0, 1, 3000)}
    gids = (np.arange(3000) % 5).astype(np.int64)
    plan = staging.plan_stream(data, 3000, 1024, block_rows=512, num_groups=5,
                               has_gids=True, gids=gids)
    rows, packed, pgids, nbytes = staging.pack_stream_window(plan, data, gids, 1, skip_cols=True)
    full = staging.pack_stream_window(plan, data, gids, 1)
    assert rows == 1024 and packed == {} and set(full[1]) == {"a", "b"}
    if isinstance(pgids, codec.CodecPayload):
        assert pgids.plan == full[2].plan
        assert all(np.array_equal(x, y) for x, y in zip(pgids.arrays, full[2].arrays))
    else:
        assert np.array_equal(pgids, full[2])
    assert nbytes == pgids.nbytes < full[3]


# -- the residency pool (tests/test_serving.py:111-190) ----------------------------


def _fake_staged(nbytes: int):
    return types.SimpleNamespace(
        blocks={"x": torch.zeros(nbytes, dtype=torch.uint8)}, mask=None, gids=None
    )


def test_staged_nbytes_counts_every_tensor():
    st = staging.StagedColumns(
        blocks={"a": torch.zeros((1, 2, 8), dtype=torch.uint16),
                "b": torch.zeros((1, 2, 8), dtype=torch.float64)},
        mask=torch.zeros((1, 2, 8), dtype=torch.bool), num_rows=10, block_rows=8,
        gids=torch.zeros((1, 2, 8), dtype=torch.int32),
    )
    assert staged_nbytes(st) == 16 * (2 + 8 + 1 + 4)
    assert staged_nbytes(object()) == 0


def test_residency_byte_accounting_under_churn():
    pool = ResidencyPool(cap_entries=64, budget_bytes=0)
    rng = np.random.default_rng(0)
    live = {}
    for i in range(200):
        op = rng.integers(0, 3)
        if op == 0 or not live:
            key = ("t", (0, i), i)
            st = _fake_staged(int(rng.integers(100, 5000)))
            pool.insert(key, st, f"tab{i % 5}", (0, i))
            # insert supersedes older versions of the same table
            live = {
                k: v for k, v in live.items()
                if not (v[0] == f"tab{i % 5}" and v[1] != (0, i))
            }
            live[key] = (f"tab{i % 5}", (0, i), staged_nbytes(st))
        elif op == 1:
            k = list(live)[int(rng.integers(0, len(live)))]
            assert pool.get(k) is not None
        else:
            pool.clear(reason="test")
            live = {}
        assert pool.used_bytes() == sum(v[2] for v in live.values()), i
        assert len(pool) == len(live)


def test_residency_watermark_eviction_keeps_bytes_under_budget():
    budget = 10_000
    pool = ResidencyPool(cap_entries=64, budget_bytes=budget)
    for i in range(20):
        pool.insert(("k", i), _fake_staged(3000), f"t{i}", (0, 1))
        assert pool.used_bytes() <= budget
    # Hysteresis: after the eviction pass the pool sits at or under the LOW
    # watermark, not just under the high one.
    assert pool.used_bytes() <= budget * 0.80 + 3000
    ev = metrics_registry().counter("device_staged_cache_evictions_total")
    assert ev.value(reason="bytes") > 0


def test_residency_pinned_never_evicted():
    budget = 10_000
    pool = ResidencyPool(cap_entries=64, budget_bytes=budget)
    pool.insert(("pinned",), _fake_staged(4000), "hot", (0, 1))
    faults.arm("serving.evict_pinned_attempt", p=0.0)  # census only
    try:
        with pool.pin(("pinned",)):
            for i in range(10):
                pool.insert(("k", i), _fake_staged(4000), f"t{i}", (0, 1))
            # The pinned entry survived every eviction pass, and the skip
            # checked the fault site.
            assert pool.get(("pinned",)) is not None
            checks, _fired = faults.stats()["serving.evict_pinned_attempt"]
            assert checks > 0
            assert pool.pinned_bytes() == staged_nbytes(_fake_staged(4000))
    finally:
        faults.reset()
    # After unpin it is ordinary LRU prey again.
    for i in range(10, 16):
        pool.insert(("k", i), _fake_staged(4000), f"t{i}", (0, 1))
    assert pool.get(("pinned",)) is None


def test_residency_version_supersession_defers_for_pinned():
    pool = ResidencyPool(cap_entries=8, budget_bytes=0)
    pool.insert(("a", 1), _fake_staged(1000), "hot", (0, 1))
    with pool.pin(("a", 1)):
        # A write bumps the version: the old staging leaves the key table
        # (lookups miss) but its bytes stay until the fold unpins.
        pool.insert(("a", 2), _fake_staged(1200), "hot", (0, 2))
        assert pool.get(("a", 1)) is None
        assert pool.used_bytes() == 2200
        assert pool.snapshot()["zombie_entries"] == 1
    assert pool.used_bytes() == 1200
    assert pool.snapshot()["zombie_entries"] == 0


def test_resident_windows_count_as_pinned_and_survive_clear():
    pool = ResidencyPool(cap_entries=2, budget_bytes=0)
    pool.register_resident(("resident", "t", 0), 500)
    pool.insert(("k", 0), _fake_staged(100), "t", (0, 1))
    pool.clear(reason="test")
    snap = pool.snapshot()
    assert snap["resident_windows"] == 1 and snap["used_bytes"] == snap["pinned_bytes"] == 500
    pool.release_resident(("resident", "t", 0))
    assert pool.used_bytes() == pool.pinned_bytes() == 0


def test_executor_entry_cap_is_the_lru_of_before():
    """With no byte budget (the default) the executor's pool is the
    entry-count LRU it replaced: the least recently used entry goes."""
    flags.set("staged_cache_cap", 2)
    try:
        ex = DeviceExecutor(device="cpu")
    finally:
        flags.reset("staged_cache_cap")

    def key(t):
        return (t, (0, 1), ("c",), None, None, 1024, "k", 1, (), ())

    ex._staged_insert(key("a"), _fake_staged(10))
    ex._staged_insert(key("b"), _fake_staged(10))
    assert ex._staged_lookup(key("a"))[1] is not None  # touch a
    ex._staged_insert(key("c"), _fake_staged(10))
    assert ex._staged_lookup(key("b"))[1] is None
    assert ex._staged_lookup(key("a"))[1] is not None and len(ex._staged_cache) == 2
