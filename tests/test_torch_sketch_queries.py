"""The sketch slice end to end: BASELINE configs 5 (t-digest + count-min over
http_events) and 3 (px/net_flow_graph: groupby(src, dst) byte sums + HLL
distinct ports over conn_flows), verbatim from bench.py, through the port's
Carnot + DeviceExecutor(device="cpu") against the reference's Carnot +
MeshExecutor on a one-device CPU mesh, over the same numpy tables.

Held exactly: the group set and order, the byte sums, the HLL distinct
counts (equal registers; the rounded estimates agree unless one lies within
1e-12 of a .5 boundary), and the count-min JSON letter for letter. The
t-digest quantiles, parsed from the JSON, within a relative 1e-2 of the
reference's (the Fault-4 contract, PERF.md) plus 1e-5 of the group's largest
quantile (the reference's FMA contraction, ``assert_quantiles_close``), and
at least three quarters of them within 1e-5 (the .6g text and f32 summation
order only).
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.table.column import DictColumn as RefDictColumn
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.utils import flags

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

SKETCHES = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    lat=('latency', px.quantiles_tdigest),\n"
    "    freq=('resp_status', px.count_min),\n"
    ")\n"
    "px.display(s, 'sketches')\n"
)
FLOWS = (
    "df = px.DataFrame(table='conn_flows')\n"
    "s = df.groupby(['src', 'dst']).agg(\n"
    "    bytes_sent=('bytes_sent', px.sum),\n"
    "    bytes_recv=('bytes_recv', px.sum),\n"
    "    ports=('remote_port', px.approx_count_distinct),\n"
    ")\n"
    "px.display(s, 'flows')\n"
)
N_PODS = 64


def http_events(n: int, seed: int = 42, n_services: int = 16) -> dict:
    """bench.py's http_events mix: status {200: .85, 301/404/500: .05},
    exponential(3e7) latency."""
    rng = np.random.default_rng(seed)
    opts = np.array([200, 301, 404, 500], np.int64)
    status = opts[np.searchsorted(np.cumsum([0.85, 0.05, 0.05, 0.05]), rng.random(n), side="right")]
    names = np.array([f"ns/svc-{i}" for i in range(n_services)], dtype=object)
    return {
        "table": "http_events",
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": names[rng.integers(0, n_services, n)],
        "resp_status": status,
        "latency": rng.exponential(3e7, n),
    }


def conn_flows(n: int, seed: int = 45) -> dict:
    """bench.py's conn_flows (build_flows): 64 pods each side, remote_port
    uniform in [1024, 65535), byte counts uniform in [0, 2^20)."""
    rng = np.random.default_rng(seed)
    return {
        "table": "conn_flows",
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "src": rng.integers(0, N_PODS, n, dtype=np.uint8),
        "dst": rng.integers(0, N_PODS, n, dtype=np.uint8),
        "remote_port": rng.integers(1024, 65535, n, dtype=np.uint16),
        "bytes_sent": rng.integers(0, 1 << 20, n, dtype=np.uint32),
        "bytes_recv": rng.integers(0, 1 << 20, n, dtype=np.uint32),
    }


def _fill(store, data: dict, dict_column, dt, relation_of, st) -> None:
    if data["table"] == "http_events":
        rel = relation_of(
            ("time_", dt.TIME64NS, st.ST_TIME_NS),
            ("service", dt.STRING, st.ST_SERVICE_NAME),
            ("resp_status", dt.INT64),
            ("latency", dt.FLOAT64, st.ST_DURATION_NS),
        )
        cols = {k: v for k, v in data.items() if k != "table"}
        store.create_table("http_events", rel).write_pydict(cols)
        return
    rel = relation_of(
        ("time_", dt.TIME64NS, st.ST_TIME_NS), ("src", dt.STRING), ("dst", dt.STRING),
        ("remote_port", dt.INT64), ("bytes_sent", dt.INT64), ("bytes_recv", dt.INT64),
    )
    t = store.create_table("conn_flows", rel)
    for col in ("src", "dst"):  # identity codes, as bench.py
        for i in range(N_PODS):
            t.dictionaries[col].get_code(f"default/pod-{i}")
    cols = {k: v for k, v in data.items() if k != "table"}
    for col in ("src", "dst"):
        cols[col] = dict_column(data[col].astype(np.int32), t.dictionaries[col])
    t.write_pydict(cols)


def run_port(data: dict, query: str, name: str, block_rows: int = 1 << 14,
             executor: DeviceExecutor = None) -> dict:
    port = Carnot(
        device_executor=executor or DeviceExecutor(device="cpu", block_rows=block_rows)
    )
    _fill(port.table_store, data, DictColumn, DataType, Relation.of, SemanticType)
    return port.execute_query(query).table(name)


def run_ref(data: dict, query: str, name: str) -> dict:
    ref = RefCarnot(
        device_executor=MeshExecutor(
            mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=1 << 14
        )
    )
    _fill(ref.table_store, data, RefDictColumn, RefDT, RefRelation.of, RefST)
    out = ref.execute_query(query).table(name)
    # The reference folded on its device path, not on its host AggNode.
    assert ref.device_executor.last_fold_ms is not None
    assert not ref.device_executor.fallback_errors
    return out


def assert_quantiles_close(got: list, want: list) -> None:
    """Each group's parsed quantiles: |port - ref| <= 1e-2 * |ref| +
    1e-5 * max|ref| of the group, and three quarters within 1e-5 * |ref|.
    The absolute term: inside its fused finalize program XLA-CPU contracts
    the reference's q * total - c_lo into an FMA, so where the interpolation
    starts at an empty centroid (mean 0) whose cumulative weight equals the
    target in f32, the reference returns ~2^-24 * m_hi where the port (and
    the reference's quantile_values compiled alone) returns 0."""
    rel = []
    for gq, wq in zip(got, want):
        g, w = json.loads(gq), json.loads(wq)
        assert list(g) == list(w)
        top = max(abs(v) for v in w.values())
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-2 * abs(w[k]) + 1e-5 * top, (k, g[k], w[k])
            rel.append(abs(g[k] - w[k]) / max(abs(w[k]), 1e-300))
    assert (np.array(rel) <= 1e-5).mean() >= 0.75, np.sort(rel)[-10:]


def assert_sketches_match(got: dict, want: dict) -> None:
    assert got["service"] == want["service"]  # groups and their order
    assert got["freq"] == want["freq"]  # count-min JSON, letter for letter
    assert_quantiles_close(got["lat"], want["lat"])


def assert_flows_match(got: dict, want: dict) -> None:
    assert got["src"] == want["src"] and got["dst"] == want["dst"]
    assert got["bytes_sent"] == want["bytes_sent"]
    assert got["bytes_recv"] == want["bytes_recv"]
    assert got["ports"] == want["ports"]


def test_config5_sketches_match_reference():
    kernels.reset_launches()
    data = http_events(200_000)
    got = run_port(data, SKETCHES, "sketches")
    want = run_ref(data, SKETCHES, "sketches")
    assert len(got["service"]) == 16
    assert sum(json.loads(f)["total"] for f in got["freq"]) == 200_000
    assert_sketches_match(got, want)
    # On the CPU the plain versions ran: no CUDA kernel was launched.
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_config3_flows_match_reference():
    data = conn_flows(200_000)
    got = run_port(data, FLOWS, "flows")
    want = run_ref(data, FLOWS, "flows")
    assert len(got["src"]) == N_PODS * N_PODS
    assert sum(got["bytes_sent"]) == int(data["bytes_sent"].astype(np.int64).sum())
    assert_flows_match(got, want)


@pytest.mark.parametrize(
    "data_fn, query, name",
    [
        (http_events, SKETCHES.replace(
            "df = px.DataFrame(table='http_events')\n",
            "df = px.DataFrame(table='http_events')\ndf = df[df.latency > 5e7]\n"),
         "sketches"),
        (conn_flows, FLOWS.replace(
            "df = px.DataFrame(table='conn_flows')\n",
            "df = px.DataFrame(table='conn_flows')\ndf = df[df.bytes_sent > 1040000]\n"),
         "flows"),
    ],
    ids=["config5", "config3"],
)
def test_filtered_sketch_queries_match_reference(data_fn, query, name):
    """A filter that empties some (src, dst) groups: only observed groups,
    in the GroupEncoder's order."""
    data = data_fn(120_000)
    got = run_port(data, query, name)
    want = run_ref(data, query, name)
    if name == "flows":
        assert 0 < len(got["src"]) < N_PODS * N_PODS
        assert_flows_match(got, want)
    else:
        assert_sketches_match(got, want)


@pytest.mark.parametrize(
    "data_fn, query, name, budget_mb, passes",
    [
        (http_events, SKETCHES, "sketches", 1, 2),  # 8 groups of count-min per pass
        (conn_flows, FLOWS, "flows", 4, 16),  # 256 (src, dst) groups per pass
    ],
    ids=["config5", "config3"],
)
def test_multi_pass_sketch_queries_match_reference(data_fn, query, name, budget_mb, passes):
    data = data_fn(60_000)
    ref_flags.set("device_group_state_budget_mb", budget_mb)
    flags.set("device_group_state_budget_mb", budget_mb)
    try:
        ex = DeviceExecutor(device="cpu", block_rows=1 << 14)
        groups = 16 if name == "sketches" else N_PODS * N_PODS
        assert ex._pass_plan(_specs_of(name), groups)[1] == passes
        got = run_port(data, query, name, executor=ex)
        want = run_ref(data, query, name)
    finally:
        ref_flags.reset("device_group_state_budget_mb")
        flags.reset("device_group_state_budget_mb")
    if name == "flows":
        assert_flows_match(got, want)
    else:
        assert_sketches_match(got, want)


def _specs_of(name: str) -> list:
    from pixie_tpu_torch.udf.registry import default_registry

    reg = default_registry()
    if name == "sketches":
        pairs = [("quantiles_tdigest", DataType.FLOAT64), ("count_min", DataType.INT64)]
    else:
        pairs = [("sum", DataType.INT64), ("sum", DataType.INT64),
                 ("approx_count_distinct", DataType.INT64)]
    return [(f"o{i}", None, reg.lookup_uda(u, [t])) for i, (u, t) in enumerate(pairs)]


def test_key_plan_is_cached_per_table_version():
    """The host-densified key plan of config 3 is built once per table
    version; a write invalidates it."""
    data = conn_flows(20_000)
    ex = DeviceExecutor(device="cpu", block_rows=1 << 14)
    port = Carnot(device_executor=ex)
    _fill(port.table_store, data, DictColumn, DataType, Relation.of, SemanticType)
    first = port.execute_query(FLOWS).table("flows")
    (plan,) = ex._keyplan_cache.values()
    again = port.execute_query(FLOWS).table("flows")
    assert first == again
    assert list(ex._keyplan_cache.values()) == [plan]
    more = conn_flows(1_000, seed=46)
    t = port.table_store.get_table("conn_flows")
    t.write_pydict({
        k: (DictColumn(v.astype(np.int32), t.dictionaries[k]) if k in ("src", "dst") else v)
        for k, v in more.items() if k != "table"
    })
    after = port.execute_query(FLOWS).table("flows")
    assert sum(after["bytes_sent"]) == sum(first["bytes_sent"]) + int(
        more["bytes_sent"].astype(np.int64).sum()
    )
    (plan2,) = ex._keyplan_cache.values()
    assert plan2 is not plan
    ex.clear_caches()
    assert not ex._keyplan_cache and not ex._staged_cache
    assert port.execute_query(FLOWS).table("flows") == after


@pytest.mark.parametrize("uda", ["approx_count_distinct", "count_min"])
def test_string_sketch_overloads_fail_to_compile(uda):
    """The STRING overloads, which failed to compile while their lane was
    unported, now compile and fold on the device through the content-hash
    LUT (arghash) and equal the reference's device lane: the distinct
    count (equal registers) and the count-min JSON letter for letter."""
    data = http_events(20_000)
    query = (
        "df = px.DataFrame(table='http_events')\n"
        f"s = df.groupby(['resp_status']).agg(x=('service', px.{uda}))\n"
        "px.display(s, 'o')\n"
    )
    ex = DeviceExecutor(device="cpu", block_rows=1 << 14)
    got, want = run_port(data, query, "o", executor=ex), run_ref(data, query, "o")
    assert ex.last_fold_ms is not None  # the device fold took it
    assert got == want and len(got["x"]) == 4
