"""The slice end to end: px/service_stats over http_events through the port's
Carnot + DeviceExecutor(device="cpu") against the reference's Carnot +
MeshExecutor on a one-device CPU mesh, over the same numpy table.

Held exactly: the group set and order, and the counts. error_rate within an
absolute 1e-12. Each quantile equal, or within one log bin (ratio <= gamma *
(1 + 1e-9)): the Fault-1 contract lets a value at a bin edge land one bin
over (PERF.md).
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops.histogram import DEFAULT_SPEC
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.compiler import CompilerError
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.interop import table_from_columns
from pixie_tpu_torch.ops import kernels
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.utils import flags

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

SERVICE_STATS = (
    "df = px.DataFrame(table='http_events')\n"
    "df.failure = df.resp_status >= 400\n"
    "stats = df.groupby(['service']).agg(\n"
    "    throughput=('time_', px.count),\n"
    "    error_rate=('failure', px.mean),\n"
    "    latency=('latency', px.quantiles),\n"
    ")\n"
    "px.display(stats, 'service_stats')\n"
)


def _http_events(n: int, n_services: int, seed: int) -> dict:
    """bench.py's http_events mix: status {200: .85, 301/404/500: .05},
    exponential(3e7) latency."""
    rng = np.random.default_rng(seed)
    opts = np.array([200, 301, 404, 500], np.int64)
    status = opts[np.searchsorted(np.cumsum([0.85, 0.05, 0.05, 0.05]), rng.random(n), side="right")]
    names = np.array([f"ns/svc-{i}" for i in range(n_services)], dtype=object)
    return {
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": names[rng.integers(0, n_services, n)],
        "resp_status": status,
        "latency": rng.exponential(3e7, n),
    }


def _carnots(data: dict):
    """The reference's Carnot + MeshExecutor and the port's Carnot +
    DeviceExecutor(device="cpu"), each holding http_events = ``data``."""
    ref = RefCarnot(
        device_executor=MeshExecutor(
            mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=1 << 14
        )
    )
    ref_rel = RefRelation.of(
        ("time_", RefDT.TIME64NS, RefST.ST_TIME_NS),
        ("service", RefDT.STRING, RefST.ST_SERVICE_NAME),
        ("resp_status", RefDT.INT64),
        ("latency", RefDT.FLOAT64, RefST.ST_DURATION_NS),
    )
    t = ref.table_store.create_table("http_events", ref_rel)
    t.write_pydict(dict(data))
    port = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=1 << 14))
    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
        ("service", DataType.STRING, SemanticType.ST_SERVICE_NAME),
        ("resp_status", DataType.INT64),
        ("latency", DataType.FLOAT64, SemanticType.ST_DURATION_NS),
    )
    table_from_columns(port.table_store, "http_events", rel, dict(data))
    return ref, port


def _run_both(data: dict, query: str = SERVICE_STATS, name: str = "service_stats"):
    ref, port = _carnots(data)
    want = ref.execute_query(query)
    # The reference folded on its device path, not on its host AggNode.
    assert ref.device_executor.last_fold_ms is not None
    assert not ref.device_executor.fallback_errors
    got = port.execute_query(query)
    return want.table(name), got.table(name)


def _assert_service_stats_match(want: dict, got: dict) -> None:
    assert got["service"] == want["service"]  # groups and their order
    assert got["throughput"] == want["throughput"]
    np.testing.assert_allclose(got["error_rate"], want["error_rate"], rtol=0, atol=1e-12)
    bound = DEFAULT_SPEC.gamma * (1 + 1e-9)
    for gq, wq in zip(got["latency"], want["latency"]):
        g, w = json.loads(gq), json.loads(wq)
        assert list(g) == list(w)
        for k in w:
            if g[k] != w[k]:
                ratio = max(g[k], w[k]) / min(g[k], w[k])
                assert ratio <= bound, (k, g[k], w[k])


def test_service_stats_matches_reference():
    kernels.reset_launches()
    want, got = _run_both(_http_events(200_000, 16, seed=42))
    assert len(got["service"]) == 16
    assert sum(got["throughput"]) == 200_000
    _assert_service_stats_match(want, got)
    # On the CPU the plain versions ran: no CUDA kernel was launched.
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_service_stats_multi_pass_matches_reference():
    """A state budget of 1 MB holds 64 groups' quantile sketches, so 200
    services fold in 4 passes over the staged blocks on both sides."""
    data = _http_events(60_000, 200, seed=7)
    ref_flags.set("device_group_state_budget_mb", 1)
    flags.set("device_group_state_budget_mb", 1)
    try:
        ex = DeviceExecutor(device="cpu")
        from pixie_tpu_torch.udf.registry import default_registry

        specs = [
            (n, None, default_registry().lookup_uda(u, [t]))
            for n, u, t in [
                ("throughput", "count", DataType.TIME64NS),
                ("error_rate", "mean", DataType.FLOAT64),
                ("latency", "quantiles", DataType.FLOAT64),
            ]
        ]
        assert ex._pass_plan(specs, 200) == (64, 4)
        want, got = _run_both(data)
    finally:
        ref_flags.reset("device_group_state_budget_mb")
        flags.reset("device_group_state_budget_mb")
    assert len(got["service"]) == 200
    _assert_service_stats_match(want, got)


def test_filtered_groups_are_dropped_and_ordered():
    """A filter that empties some groups: only observed groups, in
    dictionary-code order."""
    query = (
        "df = px.DataFrame(table='http_events')\n"
        "df = df[df.resp_status == 500]\n"
        "df = df[df.latency > 9e7]\n"
        "stats = df.groupby(['service']).agg(\n"
        "    n=('time_', px.count),\n"
        "    total=('resp_status', px.sum),\n"
        "    lat=('latency', px.mean),\n"
        ")\n"
        "px.display(stats, 'out')\n"
    )
    want, got = _run_both(_http_events(3_000, 40, seed=3), query, "out")
    assert 0 < len(got["service"]) < 40
    assert got["service"] == want["service"]
    assert got["n"] == want["n"]
    assert got["total"] == want["total"]
    np.testing.assert_allclose(got["lat"], want["lat"], rtol=1e-12, atol=0)


@pytest.mark.parametrize(
    "agg",
    [
        "df.groupby(['resp_status']).agg(n=('time_', px.count))",  # host-gid key
        "df.groupby(['service', 'resp_status']).agg(n=('time_', px.count))",
    ],
)
def test_host_densified_keys_match_reference(agg):
    """Keys other than one dictionary-coded string column are densified on
    the host (GroupEncoder): groups, their order and the counts equal the
    reference's."""
    query = f"df = px.DataFrame(table='http_events')\nstats = {agg}\npx.display(stats, 'o')\n"
    want, got = _run_both(_http_events(5_000, 7, seed=0), query, "o")
    assert got == want


@pytest.mark.parametrize(
    "agg",
    [
        # an aggregation over an aggregation: the second runs on the host
        "df.groupby(['service']).agg(n=('time_', px.count))"
        ".groupby(['n']).agg(k=('n', px.count))",
        # a source shared with another sink: the fragment is not offloaded
        "df.groupby(['service']).agg(n=('time_', px.count))\npx.display(df, 'raw')",
    ],
)
def test_unoffloadable_fragment_runs_on_the_host_aggnode(agg):
    """What the DeviceExecutor does not take runs on the host AggNode, its
    states on the executor's device (the CPU here), and equals the
    reference's result: the second aggregation after the device fold, and
    both sinks of the shared source."""
    ref, port = _carnots(_http_events(2_000, 3, 0))
    query = f"df = px.DataFrame(table='http_events')\nstats = {agg}\npx.display(stats, 'o')\n"
    want = ref.execute_query(query)
    got = port.execute_query(query)
    assert not ref.device_executor.fallback_errors
    assert sorted(got.tables) == sorted(want.tables)
    for name in want.tables:
        assert got.table(name) == want.table(name) and got.table(name)


def test_unported_udf_fails_at_compile_time():
    port = Carnot(device_executor=DeviceExecutor(device="cpu"))
    rel = Relation.of(("time_", DataType.TIME64NS), ("latency", DataType.FLOAT64))
    table_from_columns(port.table_store, "t", rel, {"time_": [1, 2], "latency": [1.0, 2.0]})
    # A metadata function: ROADMAP queue 1 item 2, still to port.
    query = "df = px.DataFrame(table='t')\ndf.pod = px.upid_to_pod_name(df.time_)\npx.display(df, 'o')\n"
    with pytest.raises(CompilerError, match="not ported yet"):
        port.compiler.compile(query, port.table_store.relation_map())


def test_host_graph_runs_map_filter_limit():
    """A fragment with no aggregation runs on the host exec graph of a
    Carnot without a device executor (with one, a bounded scan takes the
    device scan lane: tests/test_torch_scan.py)."""
    port = Carnot()
    rel = Relation.of(("time_", DataType.TIME64NS), ("latency", DataType.FLOAT64))
    table_from_columns(
        port.table_store, "t", rel,
        {"time_": np.arange(10, dtype=np.int64), "latency": np.arange(10) * 1.5},
    )
    query = (
        "df = px.DataFrame(table='t')\n"
        "df.x = df.latency * 2.0\n"
        "df = df[df.x > 5.0]\n"
        "df = df.head(3)\n"
        "px.display(df, 'o')\n"
    )
    got = port.execute_query(query).table("o")
    assert got["x"] == [6.0, 9.0, 12.0]
