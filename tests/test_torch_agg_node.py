"""The host AggNode and its StateBatch, held against the reference's host
engine (pixie_tpu/exec/agg_node.py).

The AggNode cases of pixie_tpu's tests/test_exec.py run as built plan
fragments through both packages' exec graphs on the same table (the port's
with ``device="cpu"``: its UDA states are CPU tensors and its updates the
plain versions), plus capacity growth past 256 groups, the sketches, the
StateBatch wire format in both directions, a MERGE stage fed the
reference's partial states through ``interop``, and where the states live.

Tolerances: group keys, their order, counts, integer sums, min/max, HLL
estimates and count-min JSON exact; f64 sums and means within a relative
1e-12 (both add the same few values, perhaps in another order); quantiles
within one log bin (the Fault-1 contract).
"""

import json

import numpy as np
import pytest
import torch

import pixie_tpu.plan as rplan
import pixie_tpu_torch.plan as pplan
from pixie_tpu.exec import BridgeRouter as RefRouter, ExecState as RefExecState
from pixie_tpu.exec import ExecutionGraph as RefGraph
from pixie_tpu.exec.agg_node import AggNode as RefAggNode, StateBatch as RefStateBatch
from pixie_tpu.ops.histogram import DEFAULT_SPEC
from pixie_tpu.table.row_batch import RowBatch as RefRowBatch
from pixie_tpu.table.table_store import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu_torch.device import NoCudaDeviceError
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.exec import BridgeRouter, ExecState, ExecutionGraph
from pixie_tpu_torch.exec.agg_node import AggNode, StateBatch
from pixie_tpu_torch.interop import state_batch_from_reference, table_from_columns
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.table.table_store import TableStore
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.registry import default_registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

PKGS = {
    "ref": dict(plan=rplan, DT=RefDT, Relation=RefRelation, Store=RefStore, registry=ref_registry,
                ExecState=RefExecState, Graph=RefGraph, Router=RefRouter, AggNode=RefAggNode,
                RowBatch=RefRowBatch, state_kw={}),
    "port": dict(plan=pplan, DT=DataType, Relation=Relation, Store=TableStore,
                 registry=default_registry, ExecState=ExecState, Graph=ExecutionGraph,
                 Router=BridgeRouter, AggNode=AggNode, RowBatch=RowBatch,
                 state_kw={"device": "cpu"}),
}


def http_store(pkg: str):
    """test_exec.py's fixture: six http_events rows in two writes."""
    k = PKGS[pkg]
    DT = k["DT"]
    ts = k["Store"]()
    rel = k["Relation"].of(("time_", DT.TIME64NS), ("service", DT.STRING),
                           ("latency", DT.FLOAT64), ("resp", DT.INT64))
    t = ts.create_table("http_events", rel)
    t.write_pydict({"time_": [1, 2, 3, 4], "service": ["a", "b", "a", "c"],
                    "latency": [10.0, 20.0, 30.0, 40.0], "resp": [200, 500, 200, 404]})
    t.write_pydict({"time_": [5, 6], "service": ["b", "a"], "latency": [50.0, 60.0],
                    "resp": [200, 200]})
    t.stop()
    return ts


def run_fragment(pkg: str, frag, store, router=None):
    k = PKGS[pkg]
    state = k["ExecState"]("q1", store, k["registry"](), router=router, **k["state_kw"])
    g = k["Graph"](frag, state)
    g.execute()
    return g


def sink_rows(pkg: str, g, name: str = "out") -> dict:
    batches = [b for b in g.result_batches()[name] if b.num_rows]
    return PKGS[pkg]["RowBatch"].concat(batches).to_pydict() if batches else {}


def agg_fragment(pkg: str, source: str, values, groups=(), stage=None, sink=None):
    """MemorySource -> Agg -> MemorySink("out") (or BridgeSink(sink))."""
    p = PKGS[pkg]["plan"]
    f = p.PlanFragment()
    src = f.add(p.MemorySourceOp(source))
    kw = {} if stage is None else {"stage": getattr(p.AggStage, stage)}
    agg = f.add(p.AggOp(groups=groups, values=tuple(
        (out, p.AggregateExpression(fn, (p.ColumnRef(col),))) for out, fn, col in values
    ), **kw), [src])
    f.add(p.BridgeSinkOp(sink) if sink else p.MemorySinkOp("out"), [agg])
    return f


def both(fn) -> tuple:
    """(port's result, reference's result) of ``fn(pkg)``."""
    return fn("port"), fn("ref")


def assert_close(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        if want[k] and isinstance(want[k][0], float):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
        else:
            assert got[k] == want[k], k


def test_agg_groupby_matches_reference():
    values = [("total", "sum", "latency"), ("n", "count", "latency"),
              ("lo", "min", "latency"), ("hi", "max", "latency")]
    got, want = both(lambda pkg: sink_rows(pkg, run_fragment(
        pkg, agg_fragment(pkg, "http_events", values, groups=("service",)), http_store(pkg))))
    assert_close(got, want)
    by = dict(zip(got["service"], zip(got["total"], got["n"], got["lo"], got["hi"])))
    assert by == {"a": (100.0, 3, 10.0, 60.0), "b": (70.0, 2, 20.0, 50.0), "c": (40.0, 1, 40.0, 40.0)}


def test_agg_no_groups_matches_reference():
    values = [("n", "count", "latency"), ("avg", "mean", "latency"), ("r", "sum", "resp")]
    got, want = both(lambda pkg: sink_rows(pkg, run_fragment(
        pkg, agg_fragment(pkg, "http_events", values), http_store(pkg))))
    assert got == want == {"n": [6], "avg": [35.0], "r": [1704]}


def _quantiles_close(got: list, want: list) -> None:
    for gq, wq in zip(got, want):
        g, w = json.loads(gq), json.loads(wq)
        assert list(g) == list(w)
        for k in w:
            assert g[k] == w[k] or max(g[k], w[k]) / min(g[k], w[k]) <= DEFAULT_SPEC.gamma * (1 + 1e-9)


def test_agg_quantiles_matches_reference():
    got, want = both(lambda pkg: sink_rows(pkg, run_fragment(
        pkg, agg_fragment(pkg, "http_events", [("q", "quantiles", "latency")]), http_store(pkg))))
    _quantiles_close(got["q"], want["q"])
    assert 10.0 <= json.loads(got["q"][0])["p50"] <= 60.0


def _partial_states(pkg: str, values) -> list:
    """test_exec.py's PEM side: a PARTIAL agg behind a bridge; the
    StateBatches it pushed."""
    k = PKGS[pkg]
    router = k["Router"]()
    router.register_producer("q1", "b0")
    run_fragment(pkg, agg_fragment(pkg, "http_events", values, ("service",), "PARTIAL",
                                   sink="b0"), http_store(pkg), router)
    items = []
    while (item := router.poll("q1", "b0")) is not None:
        items.append(item)
    return items


def _merge(pkg: str, values, items: list) -> dict:
    """The Kelvin side: a MERGE agg over ``items`` pushed into a bridge."""
    k = PKGS[pkg]
    p, DT = k["plan"], k["DT"]
    ts = http_store(pkg)
    router = k["Router"]()
    router.register_producer("q1", "b0")
    for item in items:
        router.push("q1", "b0", item)
    post = p.PlanFragment()
    rel = k["Relation"].of(("service", DT.STRING), *[(o, DT.STRING) for o, _, _ in values])
    bsrc = post.add(p.BridgeSourceOp("b0", rel))
    merge = post.add(p.AggOp(
        groups=("service",),
        values=tuple((o, p.AggregateExpression(fn, (p.ColumnRef(c),))) for o, fn, c in values),
        stage=p.AggStage.MERGE, pre_agg_relation=ts.get_relation("http_events"),
    ), [bsrc])
    post.add(p.MemorySinkOp("out"), [merge])
    return sink_rows(pkg, run_fragment(pkg, post, ts, router))


SPLIT_VALUES = [("total", "sum", "latency"), ("n", "count", "latency"),
                ("hi", "max", "resp"), ("avg", "mean", "latency")]


def test_partial_merge_split_matches_reference():
    """test_exec.py:209: PARTIAL in one fragment, a bridge, MERGE in
    another (the PEM -> Kelvin split)."""
    got, want = both(lambda pkg: _merge(pkg, SPLIT_VALUES, _partial_states(pkg, SPLIT_VALUES)))
    assert_close(got, want)
    by = dict(zip(got["service"], zip(got["total"], got["n"])))
    assert by["a"] == (100.0, 3) and by["b"] == (70.0, 2)
    (sb,) = _partial_states("port", SPLIT_VALUES)
    assert isinstance(sb, StateBatch) and sb.eos and isinstance(sb.states["total"], torch.Tensor)


@pytest.mark.parametrize("route", ["port_to_port", "ref_to_port", "port_to_ref"])
def test_state_batch_wire_round_trip(route):
    """The PARTIAL stage's StateBatches through the wire format: the port's
    bytes read by the port, the reference's by the port, the port's by the
    reference (one format). Each MERGE equals the reference's own split."""
    want = _merge("ref", SPLIT_VALUES, _partial_states("ref", SPLIT_VALUES))
    src, dst = route.split("_to_")
    reader = StateBatch if dst == "port" else RefStateBatch
    items = [reader.from_bytes(sb.to_bytes()) for sb in _partial_states(src, SPLIT_VALUES)]
    assert_close(_merge(dst, SPLIT_VALUES, items), want)


def test_merge_of_reference_partial_states_through_interop():
    """The reference's PARTIAL states (numpy leaves), carried into the
    port's StateBatch by ``interop.state_batch_from_reference``, merge in the
    port's MERGE node into the reference's own MERGE result."""
    ref_items = _partial_states("ref", SPLIT_VALUES)
    want = _merge("ref", SPLIT_VALUES, ref_items)
    items = [state_batch_from_reference(sb, "cpu") for sb in ref_items]
    assert all(isinstance(sb.states["avg"]["sum"], torch.Tensor) for sb in items)
    assert_close(_merge("port", SPLIT_VALUES, items), want)


def test_windowed_agg_emits_per_window():
    """eow-delimited windows emit separately (agg_node.h:88-93), in both."""
    out = {}
    for pkg, k in PKGS.items():
        DT, p = k["DT"], k["plan"]
        rel = k["Relation"].of(("time_", DT.TIME64NS), ("v", DT.FLOAT64))
        op = p.AggOp(groups=(), values=(("total", p.AggregateExpression("sum", (p.ColumnRef("v"),))),),
                     windowed=True)
        node = k["AggNode"](op, op.output_relation([rel], k["registry"]()), 0)
        node.set_input_relation(rel, k["registry"]())
        collected = []

        class FakeChild:
            stats = type("S", (), {"total_time_ns": 0})()

            def consume_next(self, st, b, idx=0):
                collected.append(b)

        node.add_child(FakeChild())
        state = k["ExecState"]("q", k["Store"](), k["registry"](), **k["state_kw"])
        node.prepare(state)
        RB = k["RowBatch"]
        node.consume_next(state, RB.from_pydict(rel, {"time_": [1, 2], "v": [1.0, 2.0]}, eow=True))
        node.consume_next(state, RB.from_pydict(rel, {"time_": [3, 4], "v": [3.0, 4.0]},
                                                eow=True, eos=True))
        out[pkg] = [b.to_pydict()["total"] for b in collected]
    assert out["port"] == out["ref"] == [[3.0], [7.0]]


def _union_store(pkg: str):
    """Two tables whose write-side dictionaries order the same strings
    differently ("y" is code 1 in u1 and code 0 in u2)."""
    k = PKGS[pkg]
    DT = k["DT"]
    ts = k["Store"]()
    rel = k["Relation"].of(("service", DT.STRING), ("v", DT.FLOAT64))
    for name, svcs, vs in (("u1", ["x", "y", "y"], [1.0, 2.0, 5.0]), ("u2", ["y", "z"], [3.0, 4.0])):
        t = ts.create_table(name, rel)
        t.write_pydict({"service": svcs, "v": vs})
        t.stop()
    return ts


def _union_fragment(pkg: str, values, groups):
    p = PKGS[pkg]["plan"]
    f = p.PlanFragment()
    u = f.add(p.UnionOp(), [f.add(p.MemorySourceOp("u1")), f.add(p.MemorySourceOp("u2"))])
    agg = f.add(p.AggOp(groups=groups, values=tuple(
        (o, p.AggregateExpression(fn, (p.ColumnRef(c),))) for o, fn, c in values)), [u])
    f.add(p.MemorySinkOp("out"), [agg])
    return f


def test_union_cross_dictionary_matches_reference():
    """test_exec.py:381's union of tables with different write-side
    dictionaries: group keys and any(STRING) states keep string identity
    (the latch re-encodes one table's codes into the other's), and
    approx_count_distinct(STRING), the reference's check, hashes each
    string's content whatever its table's dictionary."""
    values = [("n", "count", "v"), ("total", "sum", "v"), ("who", "any", "service")]
    got, want = both(lambda pkg: sink_rows(pkg, run_fragment(
        pkg, _union_fragment(pkg, values, ("service",)), _union_store(pkg))))
    assert got == want
    assert dict(zip(got["service"], got["n"])) == {"x": 1, "y": 3, "z": 1}
    got, want = both(lambda pkg: sink_rows(pkg, run_fragment(
        pkg, _union_fragment(pkg, [("who", "any", "service")], ()), _union_store(pkg))))
    assert got == want and got["who"][0] in ("x", "y", "z")
    got, want = both(lambda pkg: sink_rows(pkg, run_fragment(pkg, _union_fragment(
        pkg, [("nd", "approx_count_distinct", "service")], ()), _union_store(pkg))))
    assert want["nd"] == [3]
    assert got == want


def test_partial_merge_any_string_matches_reference():
    """test_exec.py:418: any(STRING) across the PARTIAL/MERGE split with one
    dictionary per producer: the code states translate through the shipped
    dictionaries at the merge and decode to a real value."""

    def run(pkg):
        k = PKGS[pkg]
        p, DT = k["plan"], k["DT"]
        ts = k["Store"]()
        rel = k["Relation"].of(("service", DT.STRING), ("v", DT.FLOAT64))
        for name, svc in (("p1", "x"), ("p2", "z")):
            t = ts.create_table(name, rel)
            t.write_pydict({"service": [svc], "v": [1.0]})
            t.stop()
        router = k["Router"]()
        router.register_producer("q1", "b0")
        router.register_producer("q1", "b0")
        for name in ("p1", "p2"):
            run_fragment(pkg, agg_fragment(pkg, name, [("who", "any", "service")], (),
                                           "PARTIAL", sink="b0"), ts, router)
        post = p.PlanFragment()
        bsrc = post.add(p.BridgeSourceOp("b0", k["Relation"].of(("who", DT.STRING))))
        merge = post.add(p.AggOp(
            groups=(), values=(("who", p.AggregateExpression("any", (p.ColumnRef("service"),))),),
            stage=p.AggStage.MERGE, pre_agg_relation=rel), [bsrc])
        post.add(p.MemorySinkOp("out"), [merge])
        return sink_rows(pkg, run_fragment(pkg, post, ts, router))

    got, want = both(run)
    assert got == want and got["who"][0] in ("x", "z")


def _wide_store(pkg: str):
    k = PKGS[pkg]
    DT = k["DT"]
    rng = np.random.default_rng(11)
    n = 20_000
    ts = k["Store"]()
    t = ts.create_table("wide", k["Relation"].of(("time_", DT.TIME64NS), ("key", DT.INT64),
                                                   ("v", DT.FLOAT64), ("port", DT.INT64)))
    for part in np.array_split(np.arange(n), 4):  # four batches: capacity grows mid-stream
        t.write_pydict({"time_": part.astype(np.int64), "key": rng.integers(0, 1000, len(part)),
                        "v": rng.exponential(3e7, len(part)),
                        "port": rng.integers(0, 5000, len(part))})
    t.stop()
    return ts


def test_capacity_growth_and_sketches_match_reference():
    """1000 groups (capacity doubles from 256 over four batches) with the
    sum family, min/max and the sketches on the host AggNode: HLL estimates
    and count-min JSON exact, quantiles within one log bin."""
    values = [("n", "count", "v"), ("total", "sum", "v"), ("hi", "max", "port"),
              ("distinct", "approx_count_distinct", "port"), ("freq", "count_min", "port"),
              ("q", "quantiles", "v")]
    got, want = both(lambda pkg: sink_rows(pkg, run_fragment(
        pkg, agg_fragment(pkg, "wide", values, groups=("key",)), _wide_store(pkg))))
    assert len(got["key"]) == 1000
    _quantiles_close(got.pop("q"), want.pop("q"))
    assert_close(got, want)


def test_host_aggnode_states_live_on_the_engine_device():
    """Carnot(device="cpu") keeps the AggNode's states on the CPU. Without a
    device (nor a device executor) the AggNode resolves to CUDA when it
    prepares, which raises on a machine with no card, while a fragment with
    no aggregation still runs."""
    if torch.cuda.is_available():
        pytest.skip("checks the raise that a machine without a CUDA device gives")
    rel = Relation.of(("time_", DataType.TIME64NS), ("v", DataType.FLOAT64))
    agg = "df = px.DataFrame(table='t')\ns = df.agg(n=('v', px.count))\npx.display(s, 'o')\n"
    scan = "df = px.DataFrame(table='t')\npx.display(df, 'o')\n"
    for device, ok in (("cpu", True), (None, False)):
        c = Carnot(device=device)
        table_from_columns(c.table_store, "t", rel, {"time_": [1, 2], "v": [1.0, 2.0]})
        assert c.execute_query(scan).table("o")["v"] == [1.0, 2.0]
        if ok:
            assert c.execute_query(agg).table("o") == {"n": [2]}
        else:
            with pytest.raises(NoCudaDeviceError):
                c.execute_query(agg)
