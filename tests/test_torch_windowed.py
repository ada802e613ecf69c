"""Windowed FULL aggregations on the device lane: the port's
DeviceExecutor(device="cpu") against the reference's Carnot + MeshExecutor on
a CPU mesh, at d:1 and on a 4-shard mesh, over the same numpy tables written
window by window (a batch with ``eow`` closes a window). No PxL script makes
a windowed aggregation: each plan is a compiled query whose AggOp is made
``windowed`` and run through ``execute_plan``, as a plan from another engine
reaches one.

Held: one batch a window, in window order, ``eow`` on each and ``eos`` on the
last only; the groups and their order, counts, min and max exactly; f64 sums
and means within 1e-12 of the group's sum of |v| (PERF.md's bound, ROADMAP
Fault-17); the log-histogram quantiles within one bin (Fault-1); the t-digest
under Fault-4's contract. The port's lane also equals the port's own host
AggNode on the same plan, and it took the lane: the executor returned a result
(``last_fold_ms``), with the ``fold_windowed`` lane counted.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.ops.histogram import DEFAULT_SPEC
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.plan.operators import AggOp as RefAggOp, MemorySourceOp as RefSourceOp
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.distributed import MeshConfig
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.parallel.staging import read_columns, read_columns_windowed
from pixie_tpu_torch.plan.operators import AggOp, MemorySourceOp
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.utils import flags

torch.set_num_threads(2)

BLOCK = 1 << 10
SUM_BOUND = 1e-12
STATS = (
    "df = px.DataFrame(table='ev')\n"
    "df.failure = df.resp_status >= 400\n"
    "s = df.groupby(['service']).agg(\n"
    "    n=('time_', px.count), err=('failure', px.mean), total=('latency', px.sum),\n"
    "    avg=('latency', px.mean), lo=('latency', px.min), hi=('latency', px.max),\n"
    "    lat=('latency', px.quantiles))\n"
    "px.display(s, 'out')\n"
)
TDIGEST = (
    "df = px.DataFrame(table='ev')\n"
    "s = df.groupby(['service']).agg(n=('time_', px.count),\n"
    "    td=('latency', px.quantiles_tdigest), cm=('resp_status', px.count_min))\n"
    "px.display(s, 'out')\n"
)
COUNT_ALL = (
    "df = px.DataFrame(table='ev')\n"
    "s = df.agg(n=('time_', px.count), total=('latency', px.sum))\n"
    "px.display(s, 'out')\n"
)
GEOMETRIES = ["d1", "d4"]
SIZES = [700, 1300, 90, 2100, 400]  # the shared engines' windows (one of 90 rows)


def _rels():
    cols = (("time_", "TIME64NS"), ("service", "STRING"), ("resp_status", "INT64"),
            ("latency", "FLOAT64"))
    return (RefRelation.of(*[(n, getattr(RefDT, t)) for n, t in cols]),
            Relation.of(*[(n, getattr(DataType, t)) for n, t in cols]))


def _windows(sizes, seed: int, n_services: int = 6, t0: int = 0) -> list:
    """One column dict a window, times increasing across windows."""
    rng = np.random.default_rng(seed)
    names = np.array([f"svc-{i}" for i in range(n_services)], dtype=object)
    out, t = [], t0
    for n in sizes:
        out.append({
            "time_": np.arange(t, t + n, dtype=np.int64),
            "service": names[rng.integers(0, n_services, n)],
            "resp_status": rng.choice(np.array([200, 301, 404, 500], np.int64), n),
            "latency": rng.exponential(3e7, n),
        })
        t += n
    return out


def _ref_executor(geom: str):
    devs = jax.devices()[: 1 if geom == "d1" else 4]
    return MeshExecutor(mesh=Mesh(np.array(devs), ("d",)), block_rows=BLOCK)


def _port_executor(geom: str):
    if geom == "d1":
        return DeviceExecutor(device="cpu", block_rows=BLOCK)
    return DeviceExecutor(block_rows=BLOCK, mesh_config=MeshConfig.parse("d:4", 4),
                          devices=["cpu"] * 4)


def _fill(carnot, rel, windows: list, last_eow: bool = True) -> None:
    t = carnot.table_store.create_table("ev", rel)
    for i, w in enumerate(windows):
        t.write_pydict(dict(w), eow=last_eow or i < len(windows) - 1)
    t.stop()


def _ref_carnot(geom: str, windows: list, last_eow: bool = True):
    ref = RefCarnot(device_executor=_ref_executor(geom))
    _fill(ref, _rels()[0], windows, last_eow)
    return ref


class Engines:
    """The reference (device lane), the port (device lane) and the port's
    host graph, each holding the same windows."""

    def __init__(self, geom: str, windows: list, last_eow: bool = True):
        self.geom = geom
        self.ref = _ref_carnot(geom, windows, last_eow)
        self.port = Carnot(device_executor=_port_executor(geom))
        self.host = Carnot(device="cpu")
        for c in (self.port, self.host):
            _fill(c, _rels()[1], windows, last_eow)


def _plan(carnot, query: str, agg_cls, src_cls, start=None, stop=None):
    plan = carnot.compiler.compile(query, carnot.table_store.relation_map())
    (frag,) = plan.fragments
    for nid in frag.nodes():
        op = frag.node(nid)
        if isinstance(op, agg_cls):
            frag._nodes[nid].op = dataclasses.replace(op, windowed=True)
        elif isinstance(op, src_cls) and (start is not None or stop is not None):
            frag._nodes[nid].op = dataclasses.replace(op, start_time=start, stop_time=stop)
    return plan


def run_ref(e, query: str, **kw) -> list:
    """The windowed plan through the reference's device lane (``e`` an
    Engines, or the reference Carnot itself)."""
    ref = getattr(e, "ref", e)
    ex = ref.device_executor
    ex.last_fold_ms = None
    out = ref.execute_plan(_plan(ref, query, RefAggOp, RefSourceOp, **kw)).tables["out"]
    assert ex.last_fold_ms is not None and not ex.fallback_errors, ex.fallback_errors
    return out


def run_port(e: Engines, query: str, **kw) -> list:
    ex = e.port.device_executor
    ex.last_fold_ms = None
    segment.reduce_lanes(reset=True)
    out = e.port.execute_plan(_plan(e.port, query, AggOp, MemorySourceOp, **kw)).tables["out"]
    assert ex.last_fold_ms is not None  # the device lane took the fragment
    assert segment.reduce_lanes(reset=True).get("fold_windowed") == 1
    return out


def run_host(e: Engines, query: str, **kw) -> list:
    return e.host.execute_plan(_plan(e.host, query, AggOp, MemorySourceOp, **kw)).tables["out"]


def _flags(batches) -> list:
    return [(b.eow, b.eos) for b in batches]


def _quantiles_within_a_bin(got: list, want: list) -> None:
    bound = DEFAULT_SPEC.gamma * (1 + 1e-9)
    for gq, wq in zip(got, want):
        g, w = json.loads(gq), json.loads(wq)
        assert list(g) == list(w)
        for k in w:
            if g[k] != w[k]:
                assert max(g[k], w[k]) / min(g[k], w[k]) <= bound, (k, g[k], w[k])


def _tdigest_close(got: list, want: list) -> None:
    """The Fault-4 contract (tests/test_torch_sketch_queries.py)."""
    rel = []
    for gq, wq in zip(got, want):
        g, w = json.loads(gq), json.loads(wq)
        assert list(g) == list(w)
        top = max(abs(v) for v in w.values())
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-2 * abs(w[k]) + 1e-5 * top, (k, g[k], w[k])
            rel.append(abs(g[k] - w[k]) / max(abs(w[k]), 1e-300))
    assert (np.array(rel) <= 1e-5).mean() >= 0.75


def assert_windows_match(got: list, want: list, query: str, f64: bool = True) -> None:
    """Window by window; ``f64=False`` leaves the f64 sums and means out
    (the reference's forced matmul lane sums them at f32 precision on the
    CPU: they are held to the numpy truth instead, ``assert_f64_truth``)."""
    assert len(got) == len(want)
    assert _flags(got) == _flags(want)
    for gb, wb in zip(got, want):
        g, w = gb.to_pydict(), wb.to_pydict()
        assert list(g) == list(w)
        for k, wv in w.items():
            gv = g[k]
            if k in ("lat",):
                _quantiles_within_a_bin(gv, wv)
            elif k == "td":
                _tdigest_close(gv, wv)
            elif k in ("total", "avg", "err"):
                # positive values: the group's sum of |v| is the sum itself
                if f64:
                    np.testing.assert_allclose(gv, wv, rtol=SUM_BOUND, atol=0)
            else:
                assert gv == wv, k


def assert_f64_truth(got: list, windows: list) -> None:
    """Each window's latency sums and means within 1e-12 of math.fsum over
    the group's rows."""
    import math

    for b, w in zip(got, windows):
        d = b.to_pydict()
        for svc, total, avg in zip(d["service"], d["total"], d["avg"]):
            vals = w["latency"][w["service"] == svc]
            want = math.fsum(vals)
            assert abs(total - want) <= SUM_BOUND * want
            assert abs(avg - want / len(vals)) <= SUM_BOUND * want / len(vals)


@pytest.fixture(scope="module", params=GEOMETRIES)
def engines(request):
    return Engines(request.param, _windows(SIZES, seed=3))


@pytest.mark.parametrize("strategy", ["matmul", "scatter"])
def test_windowed_stats_match_reference(engines, strategy):
    """count, mean, sum, min/max and quantiles a window, both reference
    lanes (each under a reference executor built under it)."""
    ref_segment.set_strategy(strategy)
    try:
        want = run_ref(_ref_carnot(engines.geom, _windows(SIZES, seed=3)), STATS)
    finally:
        ref_segment.set_strategy(None)
    got = run_port(engines, STATS)
    assert len(got) == 5 and _flags(got) == [(True, False)] * 4 + [(True, True)]
    assert_windows_match(got, want, STATS, f64=strategy == "scatter")
    assert_f64_truth(got, _windows(SIZES, seed=3))


def test_windowed_stats_equal_the_host_agg_node(engines):
    got = run_port(engines, STATS)
    host = run_host(engines, STATS)
    assert_windows_match(got, host, STATS)
    for gb, hb in zip(got, host):
        g, h = gb.to_pydict(), hb.to_pydict()
        assert g["lat"] == h["lat"]  # the same bins: the same quantiles


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_windowed_tdigest_over_254_slots(geom):
    """20 windows x 16 services = 320 slots: the t-digest's wide lane."""
    e = Engines(geom, _windows([800] * 20, seed=5, n_services=16))
    got = run_port(e, TDIGEST)
    want = run_ref(e, TDIGEST)
    assert len(got) == 20
    assert_windows_match(got, want, TDIGEST)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_windowed_unclosed_last_window(geom):
    """Rows after the last eow form a final window, emitted with eos."""
    e = Engines(geom, _windows([500, 800, 300], seed=7), last_eow=False)
    got, want = run_port(e, STATS), run_ref(e, STATS)
    assert _flags(got) == [(True, False), (True, False), (True, True)]
    assert_windows_match(got, want, STATS)
    assert_windows_match(got, run_host(e, STATS), STATS)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_windowed_empty_window_group_by_none(geom):
    """A window whose rows the time bounds cut away still closes: the read
    batch has no rows and eow, and group-by-none emits its one row."""
    ws = _windows([20, 2, 11], seed=9)
    ws[0]["time_"] = np.arange(40, 60, dtype=np.int64)
    ws[1]["time_"] = np.array([0, 100], np.int64)  # both outside [40, 60]
    ws[2]["time_"] = np.arange(45, 56, dtype=np.int64)
    e = Engines(geom, ws)
    got = run_port(e, COUNT_ALL, start=40, stop=60)
    want = run_ref(e, COUNT_ALL, start=40, stop=60)
    assert [b.to_pydict()["n"] for b in got] == [[20], [0], [11]]
    assert_windows_match(got, want, COUNT_ALL)
    assert_windows_match(got, run_host(e, COUNT_ALL, start=40, stop=60), COUNT_ALL)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_windowed_time_bounds_cut_windows(geom):
    e = Engines(geom, _windows([400] * 5, seed=11))
    kw = dict(start=250, stop=1700)
    got, want = run_port(e, STATS, **kw), run_ref(e, STATS, **kw)
    assert sum(sum(b.to_pydict()["n"]) for b in got) == 1451
    assert_windows_match(got, want, STATS)
    assert_windows_match(got, run_host(e, STATS, **kw), STATS)


def test_windowed_staging_never_serves_unwindowed():
    """The staged entry of a windowed fold (its gids hold window ids) and of
    the unwindowed fold of the same query are distinct: each query, in either
    order, equals its cold result."""
    e = Engines("d1", _windows([600, 900, 500], seed=13))
    cold_win = run_port(e, STATS)
    flat = e.port.execute_query(STATS).table("out")
    assert len(e.port.device_executor._staged_cache.items()) == 2
    again = run_port(e, STATS)
    assert_windows_match(again, cold_win, STATS)
    assert e.port.execute_query(STATS).table("out") == flat
    assert sum(flat["n"]) == 2000 and len(flat["service"]) == 6
    keys = [k[6] for k, _ in e.port.device_executor._staged_cache.items()]
    assert sum(":win3" in k for k in keys) == 1


def test_read_columns_windowed_matches_reference():
    """Window ids from the cursor's eow markers, bit for bit: a window the
    time bounds empty still closes, the unclosed tail is a window, and the
    unwindowed read is ``read_columns``."""
    from pixie_tpu.parallel.staging import read_columns_windowed as ref_read

    ws = _windows([30, 2, 25, 10], seed=17)
    ws[1]["time_"] = np.array([0, 10**6], np.int64)
    ref, port = RefCarnot(), Carnot(device="cpu")
    _fill(ref, _rels()[0], ws, last_eow=False)
    _fill(port, _rels()[1], ws, last_eow=False)
    rt, pt = ref.table_store.get_table("ev"), port.table_store.get_table("ev")
    for bounds in ((None, None), (30, 100), (0, 10**6)):
        want = ref_read(rt, ["latency", "service"], *bounds)
        got = read_columns_windowed(pt, ["latency", "service"], *bounds)
        assert got[1] == want[1] and got[3] == want[3]
        np.testing.assert_array_equal(got[2], want[2])
        for c in ("latency", "service"):
            np.testing.assert_array_equal(got[0][c], want[0][c])
        cols, n = read_columns(pt, ["latency"], *bounds)
        assert n == got[1]
        np.testing.assert_array_equal(cols["latency"], got[0]["latency"])
    # [30, 100]: window 0 (times 0-29) is pruned whole, so its eow is never
    # read; window 1's rows are cut away but its batch closes it; the tail.
    assert read_columns_windowed(pt, [], 30, 100)[3] == 3


def test_windowed_declines_above_2_22_slots():
    """windows x groups above 2^22 declines before anything runs (the host
    graph then folds); at 2^22 exactly the lane takes it."""
    rel = _rels()[1]
    for n_win, take in ((4097, False), (4096, True)):
        port = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=1 << 14))
        t = port.table_store.create_table("ev", rel)
        for i in range(n_win):
            t.write_pydict({"time_": [i], "service": [f"k{i % 1024}"], "resp_status": [200],
                            "latency": [1.0]}, eow=True)
        t.stop()
        plan = _plan(port, COUNT_ALL.replace("df.agg(", "df.groupby(['service']).agg("),
                     AggOp, MemorySourceOp)
        (frag,) = plan.fragments
        out = port.device_executor.try_execute_fragment(frag, port.table_store, port.registry)
        if not take:
            assert out is None
            continue
        _, batches = out
        assert len(batches) == n_win and all(b.num_rows == 1 for b in batches)
        assert [b.to_pydict()["service"] for b in batches[:3]] == [["k0"], ["k1"], ["k2"]]
        assert batches[-1].eos and not batches[-2].eos


def test_windowed_any_takes_the_device_lane():
    """any() over a bare column with no predicate takes the host lane only
    in an unwindowed FULL fold: windowed, it folds on the device (a max of
    the codes, as the reference's)."""
    q = ("df = px.DataFrame(table='ev')\n"
         "s = df.groupby(['resp_status']).agg(who=('service', px.any), n=('time_', px.count))\n"
         "px.display(s, 'out')\n")
    e = Engines("d1", _windows([300, 500], seed=19))
    got, want = run_port(e, q), run_ref(e, q)
    assert_windows_match(got, want, q)


def test_windowed_follows_the_streaming_window_flag():
    """The streamed cold path and the warm fold of a windowed query agree
    at a stream window smaller than the table (several stream windows, not
    to be confused with the eow windows)."""
    e = Engines("d1", _windows([700, 1300, 900], seed=23))
    old, ref_old = flags.streaming_window_rows, ref_flags.streaming_window_rows
    flags.set("streaming_window_rows", 1 << 10)
    ref_flags.set("streaming_window_rows", 1 << 10)
    try:
        cold = run_port(e, STATS)
        warm = run_port(e, STATS)
        want = run_ref(e, STATS)
    finally:
        flags.set("streaming_window_rows", old)
        ref_flags.set("streaming_window_rows", ref_old)
    assert_windows_match(cold, want, STATS)
    assert_windows_match(warm, cold, STATS)
