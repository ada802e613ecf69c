"""The mesh recovery plane and the stream fold's window checkpoints: the
port's DeviceExecutor over 8 logical CPU shards against the reference's
MeshExecutor on its 8 virtual CPU devices (tests/test_mesh_recovery.py's
cases), the same faults armed in both packages' registries.

The contract: a host lost mid-fold (``mesh.host_loss``) or a hung dispatch
(``mesh.collective_timeout``, or a watchdog deadline) re-plans the same
fold on the next rung of the degradation ladder; with
``mesh_fold_checkpoint`` the stream resumes from its last window
checkpoint, and a corrupt checkpoint is discarded and the fold refolds
from its first window. The recovered output equals the unfaulted flat
fold exactly (counts, min/max, HLL, count-min, group order) but for the
f64 sums, held within 1e-12 * sum |v| of ``math.fsum`` (ROADMAP
Fault-17). Snapshots (geometry, degrades, checkpointed windows, resumes,
the breaker's open and half-open states) equal the reference's. Two cases
differ by design: with ``mesh_dispatch_timeout_s`` at 0 the port arms no
watchdog (it has no cost model yet), and an exhausted ladder raises its
MeshGeometryError where the reference hands the fragment to its host
engine (ROADMAP Difference-19).
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

from pixie_tpu.distributed.mesh import MeshConfig as RefMeshConfig
from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.utils import faults as ref_faults
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.distributed import MeshConfig, MeshGeometryError
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.parallel import DeviceExecutor, staging
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.utils import faults, flags, metrics_registry

# The CPU tests share their host with the reference's timing-sensitive
# tests under several workers: two intra-op threads.
torch.set_num_threads(2)

NDEV = 8
SUM_BOUND = 1e-12  # PERF.md's bound of a port f64 sum: 1e-12 * sum |v|
AGG_QUERY = (
    "df = px.DataFrame(table='http')\n"
    "df = df[df.status >= 1]\n"
    "g = df.groupby('service').agg("
    "n=('lat', px.count), s=('lat', px.sum),"
    " mn=('lat', px.min), mx=('lat', px.max),"
    " u=('service', px.approx_count_distinct),"
    " cm=('status', px.count_min))\n"
    "px.display(g, 'out')\n"
)
SNAP_KEYS = ("geometry", "full_geometry", "degraded", "ladder", "degrade_events",
             "checkpoint_windows", "checkpoint_resumes", "recovered_folds", "checkpoints_held")


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()
    # A dispatch the watchdog abandoned runs on to its end: wait for it, so
    # that no reaper thread is still folding when the interpreter exits.
    for th in threading.enumerate():
        if th.name == "mesh-watchdog":
            th.join(timeout=10)
            assert not th.is_alive()


@pytest.fixture
def flagset():
    """Sets a flag in BOTH packages' registries, restored after the test."""
    saved = []

    def set_(name, value):
        for f in (flags, ref_flags):
            saved.append((f, name, f.get(name)))
            f.set(name, value)

    yield set_
    for f, name, value in reversed(saved):
        f.set(name, value)


def arm(site, **kw):
    faults.arm(site, **kw)
    ref_faults.arm(site, **kw)


def _data(n=2048, nsvc=11, seed=7, integer_lat=False) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "service": np.array([f"svc{i}" for i in rng.integers(0, nsvc, n)], dtype=object),
        "status": rng.integers(0, 5, n),
        "lat": (rng.integers(1, 100, n).astype(np.float64) if integer_lat
                else rng.standard_normal(n)),
    }


def _carnot(spec, data=None):
    cfg = MeshConfig.flat(NDEV) if spec == "flat" else MeshConfig.parse(spec, NDEV)
    ex = DeviceExecutor(block_rows=256, mesh_config=cfg, devices=["cpu"] * NDEV)
    c = Carnot(device_executor=ex)
    rel = Relation.of(("service", DataType.STRING), ("status", DataType.INT64),
                      ("lat", DataType.FLOAT64))
    c.table_store.create_table("http", rel).write_pydict(
        {k: v.copy() for k, v in (data or _data()).items()})
    return c, ex


def _ref_carnot(spec, data=None):
    cfg = RefMeshConfig.flat(NDEV) if spec == "flat" else RefMeshConfig.parse(spec, NDEV)
    ex = MeshExecutor(block_rows=256, mesh_config=cfg)
    c = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("service", RefDT.STRING), ("status", RefDT.INT64),
                         ("lat", RefDT.FLOAT64))
    c.table_store.create_table("http", rel).write_pydict(
        {k: v.copy() for k, v in (data or _data()).items()})
    return c, ex


def _fold(spec, data=None):
    c, ex = _carnot(spec, data)
    return c.execute_query(AGG_QUERY).table("out"), ex


def _ref_fold(spec, data=None):
    c, ex = _ref_carnot(spec, data)
    out = c.execute_query(AGG_QUERY).table("out")
    assert not ex.fallback_errors, ex.fallback_errors
    return out, ex


@pytest.fixture(scope="module")
def truth():
    """The unfaulted flat folds: the port's, and the reference's."""
    return _fold("flat")[0], _ref_fold("flat")[0]


def _assert_same(got, truth, data=None, ctx=""):
    """``got`` equals the port's and the reference's unfaulted flat folds:
    every output but the f64 sum exactly, in the same group order; the sum
    within SUM_BOUND * sum |v| of the group's math.fsum."""
    data = data or _data()
    for want in truth:
        assert list(got) == list(want), ctx
        for k in got:
            if k != "s":
                assert got[k] == want[k], (ctx, k)
    keep = data["status"] >= 1
    for name, s in zip(got["service"], got["s"]):
        v = data["lat"][keep & (data["service"] == name)]
        assert abs(s - math.fsum(v)) <= SUM_BOUND * np.abs(v).sum(), (ctx, name)


def _snap(ex) -> dict:
    snap = ex.mesh_recovery_snapshot()
    return {k: snap[k] for k in SNAP_KEYS}


# -- the degradation ladder ---------------------------------------------------
@pytest.mark.parametrize("spec", ["hosts:4,d:2", "hosts:2,d:4", "d:8"])
def test_ladder_and_snapshot_at_rest(spec):
    ex = DeviceExecutor(mesh_config=MeshConfig.parse(spec, NDEV), devices=["cpu"] * NDEV)
    ref = MeshExecutor(block_rows=256, mesh_config=RefMeshConfig.parse(spec, NDEV))
    assert _snap(ex) == {k: ref.mesh_recovery_snapshot()[k] for k in SNAP_KEYS}
    assert all(c is None or c.total_devices == NDEV for c in ex._geom_ladder)


def test_mesh_geometry_error_kinds():
    e = MeshGeometryError("host_loss", "h3 died")
    assert e.recoverable and e.kind == "host_loss"
    assert not MeshGeometryError("signature_mismatch").recoverable
    assert not MeshGeometryError("checkpoint_corrupt").recoverable
    assert MeshGeometryError("collective_timeout").recoverable
    with pytest.raises(AssertionError):
        MeshGeometryError("not_a_kind")


# -- host loss: every rung folds alike ----------------------------------------
@pytest.mark.parametrize("site,count,spec", [
    ("mesh.host_loss", 1, "hosts:4,d:2"),
    ("mesh.host_loss", 2, "hosts:4,d:2"),
    ("mesh.collective_timeout", 1, "hosts:2,d:4"),
])
def test_geometry_failure_recovers_like_the_reference(truth, site, count, spec):
    arm(site, count=count)
    out, ex = _fold(spec)
    _, ref = _ref_fold(spec)
    _assert_same(out, truth, ctx=f"{site} x{count}")
    assert _snap(ex) == {k: ref.mesh_recovery_snapshot()[k] for k in SNAP_KEYS}
    assert ex.mesh_recovery_snapshot()["degrade_events"] == count
    assert metrics_registry().counter("mesh_degrade_events_total").total() >= count


def test_geometry_restores_on_next_fold_after_transient(truth):
    c, ex = _carnot("hosts:2,d:4")
    arm("mesh.host_loss", count=1)
    out1 = c.execute_query(AGG_QUERY).table("out")
    faults.reset()
    assert ex.mesh_recovery_snapshot()["degraded"]
    out2 = c.execute_query(AGG_QUERY).table("out")
    _assert_same(out1, truth, ctx="degraded fold")
    _assert_same(out2, truth, ctx="restored fold")
    snap = ex.mesh_recovery_snapshot()
    assert snap["geometry"] == "hosts:2,d:4" and not snap["degraded"]
    assert snap["breaker"] == {}


def test_warm_fold_on_the_new_rung_reuses_the_staging(truth):
    """The warm query's host loss re-plans on d:8, which reads the entry the
    cold query staged on hosts:2,d:4: the same devices, so no shard moves
    and nothing is read or staged again."""
    c, ex = _carnot("hosts:2,d:4")
    _assert_same(c.execute_query(AGG_QUERY).table("out"), truth, ctx="cold")
    entries = [id(v) for v in ex._staged_cache.values()]
    staging.reset_cold_profile()
    arm("mesh.host_loss", count=1)
    out = c.execute_query(AGG_QUERY).table("out")
    faults.reset()
    prof = staging.reset_cold_profile()
    _assert_same(out, truth, ctx="warm across rungs")
    assert "read_columns" not in prof and "stage" not in prof, prof
    assert [id(v) for v in ex._staged_cache.values()] == entries
    snap = ex.mesh_recovery_snapshot()
    assert snap["degraded"] and snap["geometry"] == "d:8"
    _assert_same(c.execute_query(AGG_QUERY).table("out"), truth, ctx="third fold")


# -- window checkpoints: resume, not refold -----------------------------------
def test_host_kill_at_every_window_boundary_resumes(truth, flagset):
    """A host lost at every stream-window boundary (and past the last window,
    at the merge) resumes from the last checkpoint and refolds only the
    later windows: output, snapshot and resume stats as the reference's."""
    flagset("streaming_window_rows", 512)
    n_windows = 4  # 2048 rows / 512
    for boundary in range(n_windows + 1):
        arm("mesh.host_loss", count=1, after=boundary)
        segment.reduce_lanes(reset=True)
        out, ex = _fold("hosts:2,d:4")
        assert segment.reduce_lanes(reset=True).get("stage_stream") == 1
        _, ref = _ref_fold("hosts:2,d:4")
        faults.reset()
        ref_faults.reset()
        _assert_same(out, truth, ctx=f"killed at window boundary {boundary}")
        snap = _snap(ex)
        assert snap == {k: ref.mesh_recovery_snapshot()[k] for k in SNAP_KEYS}, boundary
        assert ex.last_resume_stats == ref.last_resume_stats, boundary
        assert snap["degrade_events"] == 1 and snap["checkpoints_held"] == 0
        if boundary == 0:
            assert snap["checkpoint_resumes"] == 0 and ex.last_resume_stats is None
        else:
            assert snap["checkpoint_resumes"] == 1
            assert ex.last_resume_stats == {
                "resumed_from_window": boundary,
                "refolded_windows": n_windows - boundary,
                "total_windows": n_windows,
            }


def test_mid_window_timeout_resumes_from_last_checkpoint(truth, flagset):
    flagset("streaming_window_rows", 512)
    arm("mesh.collective_timeout", count=1, after=2)
    out, ex = _fold("hosts:2,d:4")
    _assert_same(out, truth, ctx="mid-window hang")
    assert ex.last_resume_stats == {
        "resumed_from_window": 2, "refolded_windows": 2, "total_windows": 4,
    }


def test_corrupt_checkpoint_discards_and_refolds(truth, flagset):
    flagset("streaming_window_rows", 512)
    arm("mesh.host_loss", count=1, after=2)
    arm("mesh.checkpoint_corrupt", count=1)
    out, ex = _fold("hosts:2,d:4")
    _, ref = _ref_fold("hosts:2,d:4")
    assert faults.stats()["mesh.checkpoint_corrupt"][1] == 1, "the resume read the checkpoint"
    _assert_same(out, truth, ctx="refold after a corrupt checkpoint")
    snap = _snap(ex)
    assert snap == {k: ref.mesh_recovery_snapshot()[k] for k in SNAP_KEYS}
    assert snap["checkpoint_resumes"] == 0 and snap["checkpoints_held"] == 0
    assert ex.last_resume_stats is None


def test_a_checkpoint_of_other_shapes_is_corrupt(flagset):
    """A checkpoint whose leaves do not fit the fold's fresh carries (shape,
    dtype or count) is discarded, never resumed."""
    ex = DeviceExecutor(mesh_config=MeshConfig.parse("hosts:2,d:2", 4), devices=["cpu"] * 4)
    carries = [{"states": [torch.zeros(4, dtype=torch.int64)], "n": 3}] * 2
    ex._checkpoint_carries("k", 2, carries)
    got, w = ex._load_fold_checkpoint("k", carries, ex.mesh.devices)
    assert w == 2 and got[0]["n"] == 3 and torch.equal(got[1]["states"][0], carries[0]["states"][0])
    assert got[0]["states"][0] is not carries[0]["states"][0]  # a copy, not the checkpoint
    wider = [{"states": [torch.zeros(5, dtype=torch.int64)], "n": 3}] * 2
    assert ex._load_fold_checkpoint("k", wider, ex.mesh.devices) == (None, 0)
    assert ex.mesh_recovery_snapshot()["checkpoints_held"] == 0


def test_checkpointing_off_still_recovers_by_refolding(truth, flagset):
    flagset("streaming_window_rows", 512)
    flagset("mesh_fold_checkpoint", False)
    arm("mesh.host_loss", count=1, after=2)
    out, ex = _fold("hosts:2,d:4")
    _assert_same(out, truth, ctx="refold with checkpoints off")
    snap = ex.mesh_recovery_snapshot()
    assert snap["checkpoint_windows"] == 0 and snap["checkpoint_resumes"] == 0


def test_a_flat_executor_keeps_no_checkpoint(flagset):
    flagset("streaming_window_rows", 512)
    _, ex = _fold("flat")
    assert ex.mesh_recovery_snapshot()["checkpoint_windows"] == 0


# -- the watchdog -------------------------------------------------------------
def _mesh_ex(spec="hosts:2,d:4"):
    return DeviceExecutor(block_rows=256, mesh_config=MeshConfig.parse(spec, NDEV),
                          devices=["cpu"] * NDEV)


def test_watchdog_deadline_trips_on_hung_dispatch(flagset):
    flagset("mesh_dispatch_timeout_s", 0.05)
    ex = _mesh_ex()
    with pytest.raises(MeshGeometryError) as ei:
        ex._mesh_dispatch(lambda: time.sleep(0.3) or 7, what="test")
    assert ei.value.kind == "collective_timeout"
    # A fast dispatch clears the same deadline (after the hung one drains).
    assert ex._mesh_dispatch(lambda: 7, what="test") == 7


def test_watchdog_disabled_paths(flagset):
    flagset("mesh_dispatch_timeout_s", -1.0)
    ex = _mesh_ex()
    assert ex._watchdog_deadline() is None
    assert ex._mesh_dispatch(lambda: time.sleep(0.06) or 3) == 3
    # A flat mesh checks no site and arms no watchdog.
    flagset("mesh_dispatch_timeout_s", 0.01)
    ex_flat = _mesh_ex("d:8")
    faults.arm("mesh.host_loss", count=1)
    assert ex_flat._mesh_dispatch(lambda: time.sleep(0.05) or 5) == 5
    assert faults.stats()["mesh.host_loss"][0] == 0


def test_watchdog_flag_zero_arms_nothing(flagset):
    """Replaces the reference's test_watchdog_deadline_derives_from_cost_model:
    with the flag at 0 the reference derives a deadline from its cost model
    (pixie_tpu/parallel/pipeline.py:1634-1654); the port has none yet, so 0
    arms no watchdog and a positive flag is the deadline."""
    flagset("mesh_dispatch_timeout_s", 0.0)
    ex = _mesh_ex()
    assert ex._watchdog_deadline() is None
    assert ex._mesh_dispatch(lambda: time.sleep(0.05) or 4) == 4
    flagset("mesh_dispatch_timeout_s", 2.5)
    assert ex._watchdog_deadline() == 2.5


def test_watchdog_timeout_recovers_through_the_ladder(truth, flagset, monkeypatch):
    """A really hung first-rung dispatch (no injected error) trips the
    deadline and the ladder recovers the fold on the flat rung."""
    c, ex = _carnot("hosts:2,d:4")
    flagset("mesh_dispatch_timeout_s", 0.2)
    orig = DeviceExecutor._watchdog_run
    hung = {"n": 0}

    def hang_once_on_full(self, deadline, fn, what):
        if self._mesh_sig == "hosts:2,d:4" and hung["n"] == 0:
            hung["n"] += 1
            return orig(self, deadline, lambda: time.sleep(deadline + 0.3) or fn(), what)
        return orig(self, deadline, fn, what)

    monkeypatch.setattr(DeviceExecutor, "_watchdog_run", hang_once_on_full)
    out = c.execute_query(AGG_QUERY).table("out")
    assert hung["n"] == 1
    _assert_same(out, truth, ctx="a hang the watchdog caught")
    snap = ex.mesh_recovery_snapshot()
    assert snap["degrade_events"] >= 1 and snap["geometry"] == "d:8"


# -- the per-geometry breaker -------------------------------------------------
def _expire_breaker(ex, sig):
    with ex._geom_lock:
        ex._geom_breaker[sig][1] = time.monotonic() - 0.01


def test_breaker_trips_skips_rung_and_half_open_recovers(truth, flagset):
    """Two consecutive failures open the breaker: later folds start on the
    surviving rung without checking the dead geometry; the cooldown's end
    admits the half-open trial, whose success restores the full geometry.
    The breaker's states walk as the reference's do."""
    flagset("mesh_breaker_threshold", 2)
    flagset("mesh_breaker_cooldown_s", 30.0)
    c, ex = _carnot("hosts:2,d:4")
    rc, rex = _ref_carnot("hosts:2,d:4")
    states = []

    def both(query_ok_ctx):
        out = c.execute_query(AGG_QUERY).table("out")
        rc.execute_query(AGG_QUERY)
        _assert_same(out, truth, ctx=query_ok_ctx)
        snap = ex.mesh_breaker_snapshot()
        ref = rex.mesh_breaker_snapshot()
        states.append({k: (v["state"], v["failures"]) for k, v in snap.items()})
        assert states[-1] == {k: (v["state"], v["failures"]) for k, v in ref.items()}

    for i in range(2):
        arm("mesh.host_loss", count=1)
        both(f"failure {i}")
    faults.reset()
    ref_faults.reset()
    assert states[-1] == {"hosts:2,d:4": ("open", 2)}
    assert ex.mesh_breaker_snapshot()["hosts:2,d:4"]["open_remaining_s"] > 0
    faults.arm("mesh.host_loss", p=0)  # counts the site's checks only
    both("breaker open")
    assert faults.stats()["mesh.host_loss"][0] == 0, "an open breaker skips the geometry"
    faults.reset()
    assert ex.mesh_recovery_snapshot()["geometry"] == "d:8"
    _expire_breaker(ex, "hosts:2,d:4")
    _expire_breaker(rex, "hosts:2,d:4")
    assert ex.mesh_breaker_snapshot()["hosts:2,d:4"]["state"] == "half_open"
    both("half-open trial")
    snap = ex.mesh_recovery_snapshot()
    assert snap["geometry"] == "hosts:2,d:4" and not snap["degraded"] and snap["breaker"] == {}


def test_breaker_reopens_on_failed_half_open_trial(truth, flagset):
    flagset("mesh_breaker_threshold", 1)
    flagset("mesh_breaker_cooldown_s", 30.0)
    c, ex = _carnot("hosts:2,d:4")
    faults.arm("mesh.host_loss", count=1)
    _assert_same(c.execute_query(AGG_QUERY).table("out"), truth, ctx="trip")
    _expire_breaker(ex, "hosts:2,d:4")
    faults.arm("mesh.host_loss", count=1)  # the half-open trial fails too
    _assert_same(c.execute_query(AGG_QUERY).table("out"), truth, ctx="failed trial")
    br = ex.mesh_breaker_snapshot()["hosts:2,d:4"]
    assert br["state"] == "open" and br["failures"] == 2


# -- the end of the ladder -----------------------------------------------------
def test_flat_rung_is_immune_to_host_loss_sites(truth):
    faults.arm("mesh.host_loss")  # unlimited: every multi-axis rung dies
    out, ex = _fold("hosts:4,d:2")
    _assert_same(out, truth, ctx="the flat rung under unlimited host loss")
    snap = ex.mesh_recovery_snapshot()
    assert snap["geometry"] == "d:8" and snap["degrade_events"] == 2


def test_exhausted_ladder_raises(monkeypatch):
    """Replaces the reference's test_exhausted_ladder_falls_back_to_host_
    bit_identical: when every rung fails, the reference hands the fragment
    to its host engine; the port raises the last MeshGeometryError to the
    caller (ROADMAP Difference-19), after one degrade a rung, as the
    reference counts them."""
    c, ex = _carnot("hosts:4,d:2")

    def die(*a, **k):
        raise MeshGeometryError("host_loss", "every geometry is gone")

    monkeypatch.setattr(ex, "_try_execute_fragment", die)
    with pytest.raises(MeshGeometryError, match="every geometry is gone"):
        c.execute_query(AGG_QUERY)
    assert ex.mesh_recovery_snapshot()["degrade_events"] == 3  # every rung


def test_a_non_recoverable_error_is_not_retried(monkeypatch):
    c, ex = _carnot("hosts:2,d:4")
    calls = []

    def mismatch(*a, **k):
        calls.append(ex._mesh_sig)
        raise MeshGeometryError("signature_mismatch", "stale program")

    monkeypatch.setattr(ex, "_try_execute_fragment", mismatch)
    with pytest.raises(MeshGeometryError, match="signature_mismatch"):
        c.execute_query(AGG_QUERY)
    assert calls == ["hosts:2,d:4"] and ex.mesh_recovery_snapshot()["degrade_events"] == 0
