"""The PEM/Kelvin plan splitter: the port's DistributedPlanner against the
reference's (pixie_tpu/distributed/planner.py) on the same compiled queries
and topologies (the reference's splitter cases, tests/test_distributed.py:58-136,
and more shapes). Held: the fragments, operator by operator in topological
order with their parents, and each fragment's ``executing_instance``; the
errors for a topology without a Kelvin or without an agent holding the
tables.
"""

import dataclasses
import enum

import pytest

from pixie_tpu.compiler import Compiler as RefCompiler
from pixie_tpu.distributed import AgentInfo as RefAgent, DistributedPlanner as RefPlanner
from pixie_tpu.distributed import DistributedState as RefState
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu_torch.compiler import Compiler
from pixie_tpu_torch.distributed import AgentInfo, DistributedPlanner, DistributedState
from pixie_tpu_torch.plan.operators import (
    AggOp,
    AggStage,
    BridgeSinkOp,
    BridgeSourceOp,
    LimitOp,
)
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.registry import default_registry

COLS = {
    "http_events": (("time_", "TIME64NS"), ("service", "STRING"), ("latency", "FLOAT64"),
                    ("resp_status", "INT64")),
    "owners": (("service", "STRING"), ("team", "STRING")),
}
AGG_QUERY = (  # tests/test_distributed.py:39
    "df = px.DataFrame(table='http_events')\n"
    "stats = df.groupby(['service']).agg(\n"
    "    total=('latency', px.sum), n=('latency', px.count))\n"
    "px.display(stats, 'out')\n"
)
QUERIES = {
    "partial_agg": AGG_QUERY,
    "limit": "df = px.DataFrame(table='http_events')\npx.display(df.head(7), 'out')\n",
    "filter_map_agg": (
        "df = px.DataFrame(table='http_events')\n"
        "df = df[df.resp_status >= 400]\n"
        "df.ms = df.latency / 1000000.0\n"
        "s = df.groupby(['service', 'resp_status']).agg(m=('ms', px.mean),\n"
        "    q=('latency', px.quantiles), t=('latency', px.quantiles_tdigest))\n"
        "s = s[s.m > 1.0]\n"
        "px.display(s, 'out')\n"
    ),
    "no_groups": (
        "df = px.DataFrame(table='http_events')\n"
        "s = df.agg(n=('time_', px.count))\n"
        "px.display(s, 'out')\n"
    ),
    "agg_then_head": AGG_QUERY.replace("px.display(stats, 'out')",
                                       "px.display(stats.head(3), 'out')"),
    "scan_filter": (
        "df = px.DataFrame(table='http_events')\n"
        "df = df[df.latency > 1e7]\n"
        "df = df[['time_', 'service']]\n"
        "px.display(df, 'out')\n"
    ),
    "join": (
        "l = px.DataFrame(table='http_events')\n"
        "r = px.DataFrame(table='owners')\n"
        "j = l.merge(r, how='inner', left_on=['service'], right_on=['service'],\n"
        "    suffixes=['', '_r'])\n"
        "px.display(j, 'out')\n"
    ),
    "join_agg": (
        "l = px.DataFrame(table='http_events')\n"
        "r = px.DataFrame(table='owners')\n"
        "j = l.merge(r, how='inner', left_on=['service'], right_on=['service'],\n"
        "    suffixes=['', '_r'])\n"
        "s = j.groupby(['team']).agg(n=('latency', px.count))\n"
        "px.display(s, 'out')\n"
    ),
    "two_sinks": (
        "df = px.DataFrame(table='http_events')\n"
        "s = df.groupby(['service']).agg(n=('time_', px.count))\n"
        "px.display(s, 'a')\n"
        "px.display(df.head(2), 'b')\n"
    ),
}
TOPOLOGIES = {
    # tests/test_distributed.py:49: pem3 holds no tables and is pruned
    "pruned": [("pem1", ("http_events",)), ("pem2", ("http_events",)), ("pem3", ()),
               ("kelvin", None)],
    "one_pem": [("kelvin", None), ("pem1", ("http_events", "owners"))],
    "three_pems": [("pem1", ("http_events", "owners")), ("pem2", ("http_events", "owners")),
                   ("pem3", ("http_events", "owners", "extra")), ("kelvin", None)],
}


def _rels(pkg: str) -> dict:
    DT, R = (RefDT, RefRelation) if pkg == "ref" else (DataType, Relation)
    return {t: R.of(*[(n, getattr(DT, d)) for n, d in cols]) for t, cols in COLS.items()}


def _state(pkg: str, topo: str):
    A, S = (RefAgent, RefState) if pkg == "ref" else (AgentInfo, DistributedState)
    return S([A(name, frozenset(), is_kelvin=True) if tables is None
              else A(name, frozenset(tables)) for name, tables in TOPOLOGIES[topo]])


def split(pkg: str, query: str, topo: str):
    rels = _rels(pkg)
    comp, planner, reg = (RefCompiler, RefPlanner, ref_registry) if pkg == "ref" else (
        Compiler, DistributedPlanner, default_registry)
    logical = comp().compile(query, rels, query_id="q")
    return planner(reg(), rels).plan(logical, _state(pkg, topo))


def canon(x):
    """A package-free form of an operator's fields: dataclasses by class name
    and fields, enums by name, relations by (name, type) columns."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return x.name
    if hasattr(x, "col_names") and hasattr(x, "col"):
        return tuple((c.name, c.data_type.name) for c in x)
    if isinstance(x, (tuple, list)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, canon(v)) for k, v in x.items()))
    return repr(x)


def fragments(plan) -> list:
    """[(instance, [(node, canon(op), parents)])] in topological order."""
    out = []
    for f in plan.fragments:
        nodes = [(nid, canon(f.node(nid)), tuple(f.parents(nid))) for nid in f.topo_order()]
        out.append((plan.executing_instance[f.fragment_id], nodes))
    return out


def outcome(pkg: str, query: str, topo: str):
    """The split's fragments, or the error it raises (its type and text): a
    topology where no agent holds every table raises ValueError, and a
    second sink that reads the cut aggregation's source cannot be split
    (the source stays on the PEMs) and raises KeyError, in both packages."""
    try:
        plan = split(pkg, query, topo)
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)
    assert plan.query_id == "q"
    return fragments(plan)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_split_matches_reference(name, topo):
    assert outcome("port", QUERIES[name], topo) == outcome("ref", QUERIES[name], topo)


def test_splitter_partial_agg_rewrite():
    """tests/test_distributed.py:58: PEM fragments Agg(PARTIAL) ->
    BridgeSink, the Kelvin's BridgeSource -> Agg(MERGE) with the pre-agg
    relation; pem3 (no tables) pruned."""
    plan = split("port", AGG_QUERY, "pruned")
    instances = [plan.executing_instance[f.fragment_id] for f in plan.fragments]
    assert instances == ["pem1", "pem2", "kelvin"]
    for frag in plan.fragments[:2]:
        aggs = [frag.node(n) for n in frag.nodes() if isinstance(frag.node(n), AggOp)]
        assert len(aggs) == 1 and aggs[0].stage == AggStage.PARTIAL
        assert any(isinstance(frag.node(n), BridgeSinkOp) for n in frag.nodes())
    kelvin = plan.fragments[2]
    aggs = [kelvin.node(n) for n in kelvin.nodes() if isinstance(kelvin.node(n), AggOp)]
    assert len(aggs) == 1 and aggs[0].stage == AggStage.MERGE
    assert aggs[0].pre_agg_relation is not None
    assert any(isinstance(kelvin.node(n), BridgeSourceOp) for n in kelvin.nodes())


def test_splitter_forwarding_for_limit():
    """tests/test_distributed.py:91: a limit is a blocking op: the Kelvin's."""
    plan = split("port", QUERIES["limit"], "pruned")
    kelvin = plan.fragments[-1]
    assert any(isinstance(kelvin.node(n), LimitOp) for n in kelvin.nodes())
    assert [plan.executing_instance[f.fragment_id] for f in plan.fragments] == [
        "pem1", "pem2", "kelvin"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_splitter_errors(pkg):
    """No Kelvin, or no agent with every table: both packages raise."""
    A, S = (RefAgent, RefState) if pkg == "ref" else (AgentInfo, DistributedState)
    rels = _rels(pkg)
    comp, planner, reg = (RefCompiler, RefPlanner, ref_registry) if pkg == "ref" else (
        Compiler, DistributedPlanner, default_registry)
    logical = comp().compile(AGG_QUERY, rels)
    with pytest.raises(ValueError, match="kelvin"):
        planner(reg(), rels).plan(logical, S([A("pem1", frozenset({"http_events"}))]))
    logical = comp().compile(AGG_QUERY, rels)
    with pytest.raises(ValueError, match="no agent holds"):
        planner(reg(), rels).plan(logical, S([A("pem1", frozenset({"owners"})),
                                              A("k", frozenset(), is_kelvin=True)]))
