"""Non-windowed PARTIAL aggregations on the device lane (the PEM side of a
PEM/Kelvin split): the port's DeviceExecutor(device="cpu") against the
reference's MeshExecutor on a CPU mesh, at d:1 and on a 4-shard mesh, over the
same numpy tables. The plans are each package's DistributedPlanner's split of
one compiled query.

Held: the StateBatch a PEM fragment's fold returns (its key columns, group
order and ``num_groups`` exactly, only observed groups; integer states
exactly; f64 states within 1e-12 of the group's sum of |v| (ROADMAP
Fault-17); histogram counts exactly; t-digest states through their
quantiles under Fault-4's contract), the port's state leaves on the
executor's device; the Kelvin's MERGE result against the reference's split
run and against a single engine's FULL run; any(STRING) across PEMs whose
dictionaries order the strings differently; and a PARTIAL and a FULL query of
one fold run concurrently with shared scans on, each equal to its serial
result.
"""

import json
import threading
import uuid

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.compiler import Compiler as RefCompiler
from pixie_tpu.distributed import AgentInfo as RefAgent, DistributedPlanner as RefPlanner
from pixie_tpu.distributed import DistributedState as RefState
from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.exec import BridgeRouter as RefRouter
from pixie_tpu.exec.agg_node import StateBatch as RefStateBatch
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.plan.plan import Plan as RefPlan
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu_torch.compiler import Compiler
from pixie_tpu_torch.distributed import AgentInfo, DistributedPlanner, DistributedState, MeshConfig
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.exec import BridgeRouter
from pixie_tpu_torch.exec.agg_node import StateBatch
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.plan.plan import Plan
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.registry import default_registry
from pixie_tpu_torch.utils import flags

torch.set_num_threads(2)

BLOCK = 1 << 10
SUM_BOUND = 1e-12
GEOMETRIES = ["d1", "d4"]
STATS = (
    "df = px.DataFrame(table='ev')\n"
    "df.failure = df.resp_status >= 400\n"
    "s = df.groupby(['service']).agg(\n"
    "    n=('time_', px.count), err=('failure', px.mean), total=('latency', px.sum),\n"
    "    lo=('latency', px.min), hi=('latency', px.max), lat=('latency', px.quantiles),\n"
    "    codes=('resp_status', px.sum))\n"
    "px.display(s, 'out')\n"
)
SKETCHES = (
    "df = px.DataFrame(table='ev')\n"
    "s = df.groupby(['service']).agg(td=('latency', px.quantiles_tdigest),\n"
    "    cm=('resp_status', px.count_min), u=('resp_status', px.approx_count_distinct))\n"
    "px.display(s, 'out')\n"
)
NO_GROUPS = (
    "df = px.DataFrame(table='ev')\n"
    "s = df.agg(n=('time_', px.count), total=('latency', px.sum), hi=('latency', px.max))\n"
    "px.display(s, 'out')\n"
)
FILTERED = (
    "df = px.DataFrame(table='ev')\n"
    "df = df[df.resp_status >= 400]\n"
    "s = df.groupby(['service', 'resp_status']).agg(n=('time_', px.count),\n"
    "    total=('latency', px.sum))\n"
    "px.display(s, 'out')\n"
)
ANY_STRING = (
    "df = px.DataFrame(table='ev')\n"
    "s = df.groupby(['resp_status']).agg(who=('service', px.any), n=('time_', px.count))\n"
    "px.display(s, 'out')\n"
)
QUERIES = {"stats": STATS, "sketches": SKETCHES, "no_groups": NO_GROUPS, "filtered": FILTERED}
COLS = (("time_", "TIME64NS"), ("service", "STRING"), ("resp_status", "INT64"),
        ("latency", "FLOAT64"))


def _rel(pkg: str):
    if pkg == "ref":
        return RefRelation.of(*[(n, getattr(RefDT, t)) for n, t in COLS])
    return Relation.of(*[(n, getattr(DataType, t)) for n, t in COLS])


def _shard(n: int, seed: int, names: list) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n, dtype=np.int64) + seed * 10**6,
        "service": np.array(names, dtype=object)[rng.integers(0, len(names), n)],
        "resp_status": rng.choice(np.array([200, 301, 404, 500], np.int64), n),
        "latency": rng.exponential(3e7, n),
    }


# Two PEMs' tables: their services overlap, so the merge adds groups of both.
SHARDS = [_shard(3000, 1, [f"svc-{i}" for i in range(6)]),
          _shard(2500, 2, [f"svc-{i}" for i in range(3, 9)])]


def _ref_executor(geom: str):
    devs = jax.devices()[: 1 if geom == "d1" else 4]
    return MeshExecutor(mesh=Mesh(np.array(devs), ("d",)), block_rows=BLOCK)


def _port_executor(geom: str):
    if geom == "d1":
        return DeviceExecutor(device="cpu", block_rows=BLOCK)
    return DeviceExecutor(block_rows=BLOCK, mesh_config=MeshConfig.parse("d:4", 4),
                          devices=["cpu"] * 4)


class Cluster:
    """Two PEM engines (each its own executor and table) and a Kelvin, over
    one router, in either package."""

    def __init__(self, pkg: str, geom: str, shards=SHARDS, pre_codes=()):
        ref = pkg == "ref"
        self.pkg = pkg
        self.router = RefRouter() if ref else BridgeRouter()
        mk = (lambda **kw: RefCarnot(**kw)) if ref else (lambda **kw: Carnot(**kw))
        self.pems = []
        for i, data in enumerate(shards):
            ex = _ref_executor(geom) if ref else _port_executor(geom)
            c = mk(router=self.router, instance=f"pem{i}", device_executor=ex)
            t = c.table_store.create_table("ev", _rel(pkg))
            for v in pre_codes:  # dictionary slots no row uses
                t.dictionaries["service"].get_code(v)
            t.write_pydict(dict(data))
            t.stop()
            self.pems.append(c)
        self.kelvin = mk(router=self.router, instance="kelvin") if ref else Carnot(
            router=self.router, instance="kelvin", device="cpu")

    def plan(self, query: str):
        rels = {"ev": _rel(self.pkg)}
        ref = self.pkg == "ref"
        logical = (RefCompiler() if ref else Compiler()).compile(query, rels,
                                                                 query_id=str(uuid.uuid4()))
        A, S, P = (RefAgent, RefState, RefPlanner) if ref else (
            AgentInfo, DistributedState, DistributedPlanner)
        state = S([A(p.instance, frozenset({"ev"})) for p in self.pems]
                  + [A("kelvin", frozenset(), is_kelvin=True)])
        return P((ref_registry if ref else default_registry)(), rels).plan(logical, state)

    def pem_states(self, query: str) -> list:
        """Each PEM fragment's fold result: the StateBatch its executor returns."""
        plan = self.plan(query)
        out = []
        for p, frag in zip(self.pems, plan.fragments):
            ex = p.device_executor
            got = ex.try_execute_fragment(frag, p.table_store, p.registry)
            assert got is not None, "the PEM fragment did not take the device lane"
            out.append(got[1])
        return out

    def run(self, query: str) -> dict:
        """The split query as agents run it: PEMs first, then the Kelvin;
        every PEM fragment offloaded."""
        plan = self.plan(query)
        qid = plan.query_id
        P = RefPlan if self.pkg == "ref" else Plan
        subs = {}
        for f in plan.fragments:
            inst = plan.executing_instance[f.fragment_id]
            subs.setdefault(inst, P(qid)).fragments.append(f)
            subs[inst].executing_instance[f.fragment_id] = inst
            for nid in f.nodes():
                if type(f.node(nid)).__name__ == "BridgeSinkOp":
                    self.router.register_producer(qid, f.node(nid).bridge_id)
        for p in self.pems:
            p.device_executor.last_fold_ms = None
            p.execute_plan(subs[p.instance], manage_router=False)
            assert p.device_executor.last_fold_ms is not None
        res = self.kelvin.execute_plan(subs["kelvin"], manage_router=False)
        self.router.cleanup_query(qid)
        return res.table("out")


def _keys(col) -> list:
    if hasattr(col, "codes"):
        return list(col.decode())
    return np.asarray(col).tolist()


def _leaf_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tdigest_states(uda_port, got, want) -> None:
    """Both states finalized by the port's t-digest: Fault-4's contract."""
    from pixie_tpu_torch.interop import state_from_numpy

    fin = lambda st: uda_port.finalize(st)  # noqa: E731
    g = fin({k: torch.from_numpy(_leaf_np(v)) for k, v in got.items()})
    w = fin(state_from_numpy(uda_port, {k: _leaf_np(v) for k, v in want.items()}))
    for gq, wq in zip(g, w):
        gd, wd = json.loads(gq), json.loads(wq)
        top = max(abs(v) for v in wd.values())
        for k in wd:
            assert abs(gd[k] - wd[k]) <= 1e-2 * abs(wd[k]) + 1e-5 * top, (k, gd[k], wd[k])


def assert_state_batches_match(got: StateBatch, want, query: str) -> None:
    assert isinstance(got, StateBatch) and isinstance(want, RefStateBatch)
    assert got.num_groups == want.num_groups
    assert tuple(got.group_names) == tuple(want.group_names)
    assert (got.eow, got.eos) == (want.eow, want.eos) == (True, True)
    assert [_keys(c) for c in got.key_columns] == [_keys(c) for c in want.key_columns]
    assert set(got.states) == set(want.states)
    reg = default_registry()
    for name, st in got.states.items():
        leaves = st if isinstance(st, dict) else {"": st}
        wl = want.states[name] if isinstance(want.states[name], dict) else {"": want.states[name]}
        assert set(leaves) == set(wl), name
        for k, leaf in leaves.items():
            assert isinstance(leaf, torch.Tensor) and leaf.shape[0] == got.num_groups
        if name == "td":
            _assert_tdigest_states(reg.lookup_uda("quantiles_tdigest", [DataType.FLOAT64]),
                                   leaves, wl)
            continue
        for k, leaf in leaves.items():
            g, w = _leaf_np(leaf), np.asarray(wl[k])
            assert g.shape == w.shape and g.dtype == w.dtype, (name, k)
            if g.dtype.kind == "f":
                # positive latencies: the group's sum of |v| is the sum itself
                np.testing.assert_allclose(g, w, rtol=SUM_BOUND, atol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}[{k}]")


def _assert_out_match(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if k in ("lat", "td"):
            for gq, wq in zip(g, w):
                gd, wd = json.loads(gq), json.loads(wq)
                top = max(abs(v) for v in wd.values())
                for q in wd:
                    assert abs(gd[q] - wd[q]) <= 1e-2 * abs(wd[q]) + 1e-5 * top, (k, q)
        elif k in ("total", "err"):
            np.testing.assert_allclose(g, w, rtol=SUM_BOUND, atol=0)
        else:
            assert g == w, k


@pytest.fixture(scope="module", params=GEOMETRIES)
def clusters(request):
    return Cluster("ref", request.param), Cluster("port", request.param)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_partial_state_batch_matches_reference(clusters, name):
    ref, port = clusters
    segment.reduce_lanes(reset=True)
    got = port.pem_states(QUERIES[name])
    assert segment.reduce_lanes(reset=True).get("fold_partial") == 2
    want = ref.pem_states(QUERIES[name])
    for g, w in zip(got, want):
        assert_state_batches_match(g, w, QUERIES[name])


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_kelvin_merge_matches_reference_and_full(clusters, name):
    """The Kelvin's MERGE over the PEMs' device states equals the
    reference's split run, and a single engine's FULL run over both
    shards' rows (every mergeable state exactly, f64 sums within their
    bound; the t-digest only against the reference's split: two merged
    digests are not the digest of all rows)."""
    ref, port = clusters
    got = port.run(QUERIES[name])
    want = ref.run(QUERIES[name])
    if name != "sketches":
        _assert_out_match(got, want)
    else:
        assert got["service"] == want["service"] and got["cm"] == want["cm"]
        assert got["u"] == want["u"]
        _assert_out_match({"td": got["td"]}, {"td": want["td"]})
    single = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=BLOCK))
    t = single.table_store.create_table("ev", _rel("port"))
    for data in SHARDS:
        t.write_pydict(dict(data))
    full = single.execute_query(QUERIES[name]).table("out")
    # The MERGE emits groups in the order the PEMs' batches introduce them.
    order = [full_keys.index(k) for k in zip(*(got[g] for g in _group_cols(name)))] if (
        full_keys := list(zip(*(full[g] for g in _group_cols(name))))) else [0]
    for k, col in full.items():
        col = [col[i] for i in order]
        if k == "td":
            continue  # two merged digests are not one digest of the rows
        if k == "lat":
            assert got[k] == col  # merged histograms: the same bins
        elif k in ("total", "err"):
            np.testing.assert_allclose(got[k], col, rtol=SUM_BOUND, atol=0)
        else:
            assert got[k] == col, k


def _group_cols(name: str) -> list:
    return {"no_groups": [], "filtered": ["service", "resp_status"]}.get(name, ["service"])


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_partial_dictionary_key_with_unobserved_slots(geom):
    """A dictionary-keyed plan carries a slot a code no row has: the
    StateBatch ships only the observed groups, in code order."""
    pre = ("svc-x", "svc-0", "svc-y")
    ref, port = Cluster("ref", geom, pre_codes=pre), Cluster("port", geom, pre_codes=pre)
    got, want = port.pem_states(STATS), ref.pem_states(STATS)
    for g, w in zip(got, want):
        assert_state_batches_match(g, w, STATS)
        assert "svc-x" not in _keys(g.key_columns[0])
        assert _keys(g.key_columns[0])[:1] == ["svc-0"] or "svc-0" not in _keys(g.key_columns[0])
    # The same rows keyed without the extra slots: the same groups and
    # values (the MERGE emits them in another order: code order differs).
    a, b = port.run(STATS), Cluster("port", geom).run(STATS)
    rows = lambda d: {r[0]: r[1:] for r in zip(d["service"], *(d[k] for k in d if k != "service"))}  # noqa: E731
    assert rows(a) == rows(b)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_partial_any_string_with_per_pem_dictionaries(geom):
    """any(STRING) across PEMs whose dictionaries order the values
    differently (tests/test_exec.py:419): each StateBatch carries its
    table's dictionary, and the merge translates the codes."""
    shards = [_shard(400, 3, ["x", "y", "w"]), _shard(300, 4, ["z", "y"])]
    ref, port = Cluster("ref", geom, shards), Cluster("port", geom, shards)
    got = port.pem_states(ANY_STRING)
    want = ref.pem_states(ANY_STRING)
    for g, w in zip(got, want):
        assert list(g.arg_dicts) == ["who"]
        assert g.arg_dicts["who"].values() == list(w.arg_dicts["who"].values())
        assert_state_batches_match(g, w, ANY_STRING)
    out, ref_out = port.run(ANY_STRING), ref.run(ANY_STRING)
    assert out["resp_status"] == ref_out["resp_status"] and out["n"] == ref_out["n"]
    assert out["who"] == ref_out["who"]
    assert all(v in ("x", "y", "w", "z") for v in out["who"])


def test_partial_states_stay_on_the_executor_device():
    """The PARTIAL lane leaves its state leaves where the fold made them
    (the executor's root device) and fetches only the presence."""
    port = Cluster("port", "d1")
    for sb in port.pem_states(SKETCHES):
        for st in sb.states.values():
            for leaf in (st.values() if isinstance(st, dict) else [st]):
                assert isinstance(leaf, torch.Tensor) and leaf.device == torch.device("cpu")


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_partial_and_full_concurrently_with_shared_scans(geom):
    """Concurrent PARTIAL and FULL queries of one fold, with shared scans on
    and a window that gathers them: each equals its serial result (a
    PARTIAL's packed output holds raw states, a FULL's finalized values: the
    stage is in the shared-scan key)."""
    port = Cluster("port", geom)
    pem = port.pems[0]
    frag = port.plan(STATS).fragments[0]
    ex = pem.device_executor

    def partial():
        return ex.try_execute_fragment(frag, pem.table_store, pem.registry)[1]

    def full():
        return pem.execute_query(STATS).table("out")

    serial_p, serial_f = partial(), full()  # warm: both staged
    old = flags.shared_scan_window_ms
    flags.set("shared_scan_window_ms", 200.0)
    results, errors = {}, []

    def go(key, fn):
        try:
            results[key] = fn()
        except Exception as e:  # re-raised below
            errors.append(e)

    try:
        threads = [threading.Thread(target=go, args=(k, fn)) for k, fn in (
            ("p1", partial), ("f1", full), ("p2", partial), ("f2", full))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        flags.set("shared_scan_window_ms", old)
    assert not errors, errors
    for k in ("f1", "f2"):
        assert results[k] == serial_f
    for k in ("p1", "p2"):
        got = results[k]
        assert got.num_groups == serial_p.num_groups
        assert [_keys(c) for c in got.key_columns] == [_keys(c) for c in serial_p.key_columns]
        for name, st in serial_p.states.items():
            leaves = st if isinstance(st, dict) else {"": st}
            gl = got.states[name] if isinstance(got.states[name], dict) else {"": got.states[name]}
            for leaf_k, leaf in leaves.items():
                assert torch.equal(gl[leaf_k], leaf), (k, name, leaf_k)


def test_partial_state_batch_crosses_the_wire():
    """A device-lane StateBatch (tensor leaves) round-trips the port's wire
    format into the reference's reader and merges there as the reference's
    own PARTIAL states would."""
    port = Cluster("port", "d1")
    for sb in port.pem_states(STATS):
        back = RefStateBatch.from_bytes(sb.to_bytes())
        assert back.num_groups == sb.num_groups
        assert _keys(back.key_columns[0]) == _keys(sb.key_columns[0])
        n = sb.states["n"]
        np.testing.assert_array_equal(np.asarray(back.states["n"]), _leaf_np(n))
        np.testing.assert_array_equal(np.asarray(back.states["total"]),
                                      _leaf_np(sb.states["total"]))


def test_windowed_partial_stays_on_the_host_graph():
    """A windowed PARTIAL is declined by the matcher (as the reference's):
    the host AggNode runs it."""
    import dataclasses

    from pixie_tpu_torch.plan.operators import AggOp

    port = Cluster("port", "d1")
    frag = port.plan(STATS).fragments[0]
    for nid in frag.nodes():
        if isinstance(frag.node(nid), AggOp):
            frag._nodes[nid].op = dataclasses.replace(frag.node(nid), windowed=True)
    pem = port.pems[0]
    assert pem.device_executor.try_execute_fragment(frag, pem.table_store, pem.registry) is None


def test_partial_state_batch_matches_the_host_agg_node():
    """The device lane's StateBatch has the same structure as the port's
    host AggNode's PARTIAL batch for the same fragment (the MERGE reads
    both)."""
    port = Cluster("port", "d1")
    plan = port.plan(STATS)
    dev = port.pem_states(STATS)[0]
    host = Carnot(router=BridgeRouter(), device="cpu")
    t = host.table_store.create_table("ev", _rel("port"))
    t.write_pydict(dict(SHARDS[0]))
    qid, frag = plan.query_id, plan.fragments[0]
    (bid,) = {frag.node(n).bridge_id for n in frag.nodes()
              if type(frag.node(n)).__name__ == "BridgeSinkOp"}
    host.router.register_producer(qid, bid)
    sub = Plan(qid)
    sub.fragments.append(frag)
    host.execute_plan(sub, manage_router=False)
    sb = host.router.poll(qid, bid)
    assert isinstance(sb, StateBatch)
    assert sb.num_groups == dev.num_groups
    assert [_keys(c) for c in sb.key_columns] == [_keys(c) for c in dev.key_columns]
    for name, st in dev.states.items():
        hs = sb.states[name]
        assert type(hs) is type(st)
        if isinstance(st, dict):
            assert set(hs) == set(st)
        if name in ("n", "lo", "hi", "codes", "lat"):
            for a, b in zip(hs.values() if isinstance(hs, dict) else [hs],
                            st.values() if isinstance(st, dict) else [st]):
                assert torch.equal(a.cpu(), b.cpu()), name
    assert isinstance(dev.key_columns[0], DictColumn)
