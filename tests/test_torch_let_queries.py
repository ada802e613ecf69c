"""The sixth slice end to end: service_stats.pxl's LET and histogram queries
and a per-endpoint load query through the port's Carnot +
DeviceExecutor(device="cpu") against the reference's Carnot + MeshExecutor
on a one-device CPU mesh, over the same numpy http_events table, under both
of the reference's segment lanes (``segment.set_strategy``).

- Q1 ``svc_let``, Q2 ``http_code_histogram`` and Q3 ``latency_histogram``
  are the bundled script's own functions (``df.ctx['service']`` read as the
  table's ``service`` column: metadata is ROADMAP queue 1 item 2): string
  filters through dictionary-code comparisons and a ``contains`` LUT,
  ``bin`` keys on the host key plan, ``pluck_float64 -> floor ->
  DurationNanos`` after the fold.
- Q4 groups by ``regex_replace('/[0-9]+', req_path, '/{id}')``, the
  dictionary-LUT key lane, with the STRING sketches (the arghash lane),
  ``stddev``/``variance``, a ``select`` sum, ``mean(log10)`` and a
  ``floor(latency / 1e6)`` sum.

Held: groups and their order, counts, integer sums, count-min JSON and HLL
estimates exactly; the quantile-derived latencies within one log bin
(Fault-1, PERF.md); error rates, throughputs and means within a relative
1e-12 (f64 sums in another order); variance within 4e-12 * E[x^2] of the
reference's on the same group (and stddev correspondingly). Q1-Q3 run
under both forced lanes, Q4 under the scatter lane and the reference's own
choice (``ref_lane_q4``), each against a reference engine built under that
lane. Both packages must take the same device lane (checked by their lane records), and no
reference query may fall back.
"""

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
from pixie_tpu.scripts.library import ScriptLibrary
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu_torch.compiler.compiler import FuncToExecute
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels, segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.udf.builtins import NOT_PORTED

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

NOW = 1_700_000_000_000_000_000
ROW_NS = 18_000
N = 60_000
SCRIPT = ScriptLibrary().load("px/service_stats").pxl.replace(
    "df.ctx[k8s_object]", "df[k8s_object]"
)
Q1 = SCRIPT + "\npx.display(svc_let('-15m', 'svc-1'), 'let')\n"
Q2 = SCRIPT + "\npx.display(http_code_histogram('-15m', 'svc-1'), 'codes')\n"
Q3 = SCRIPT + "\npx.display(latency_histogram('-15m', 'svc-1'), 'lat_hist')\n"
Q4 = (
    "df = px.DataFrame(table='http_events', start_time='-15m')\n"
    "df.endpoint = px.regex_replace('/[0-9]+', df.req_path, '/{id}')\n"
    "df.err_bytes = px.select(df.resp_status >= 400, df.resp_body_size, 0)\n"
    "df.log_lat = px.log10(df.latency)\n"
    "df.lat_ms = px.floor(df.latency / 1000000.0)\n"
    "s = df.groupby('endpoint').agg(\n"
    "    n=('latency', px.count),\n"
    "    clients=('remote_addr', px.approx_count_distinct),\n"
    "    paths=('req_path', px.count_min),\n"
    "    sd=('latency', px.stddev),\n"
    "    var=('latency', px.variance),\n"
    "    err_bytes=('err_bytes', px.sum),\n"
    "    mlog=('log_lat', px.mean),\n"
    "    ms=('lat_ms', px.sum),\n"
    ")\n"
    "px.display(s, 'load')\n"
)
QUERIES = {"let": Q1, "codes": Q2, "lat_hist": Q3, "load": Q4}


def http_events(n: int, seed: int = 47) -> dict:
    """chip_smoke.py's Q1-Q4 table at a small size: 16 services, paths
    /api/v1/<resource>/<id> over 32 resources plus /healthz (2%) and
    /readyz (1%), client IPs plus '-' (1%), config 2's status mix,
    exponential(3e7) latency, lognormal body sizes; rows 18 us apart
    ending at NOW."""
    rng = np.random.default_rng(seed)
    services = np.array([f"svc-{i}" for i in range(16)], dtype=object)
    u = rng.random(n)
    ids = rng.integers(0, 128, n)
    res = rng.integers(0, 32, n)
    paths = np.array([f"/api/v1/r{r}/{i}" for r, i in zip(res, ids)], dtype=object)
    paths[u < 0.02] = "/healthz"
    paths[(u >= 0.02) & (u < 0.03)] = "/readyz"
    addrs = np.array([f"10.0.{i // 256}.{i % 256}" for i in range(256)], dtype=object)
    remote = addrs[rng.integers(0, 256, n)]
    remote[rng.random(n) < 0.01] = "-"
    opts = np.array([200, 301, 404, 500], np.int64)
    status = opts[np.searchsorted(np.cumsum([0.85, 0.05, 0.05, 0.05]), rng.random(n), side="right")]
    return {
        "time_": NOW - (n - np.arange(n, dtype=np.int64)) * ROW_NS,
        "service": services[rng.integers(0, 16, n)],
        "req_path": paths,
        "remote_addr": remote,
        "resp_status": status,
        "latency": rng.exponential(3e7, n),
        "resp_body_size": np.round(rng.lognormal(7, 1, n)).astype(np.int64),
    }


def _relation(dt, rel, st):
    return rel.of(
        ("time_", dt.TIME64NS, st.ST_TIME_NS), ("service", dt.STRING, st.ST_SERVICE_NAME),
        ("req_path", dt.STRING), ("remote_addr", dt.STRING), ("resp_status", dt.INT64),
        ("latency", dt.FLOAT64, st.ST_DURATION_NS), ("resp_body_size", dt.INT64, st.ST_BYTES),
    )


class _RefEngines:
    """One reference Carnot + MeshExecutor for each ``segment.set_strategy``
    lane, built under that lane at first use: an executor built under one
    lane keeps serving that lane's f64 sums after the lane is switched
    (clearing its program cache or jax's caches does not reset it)."""

    def __init__(self, data: dict):
        self.data, self.by_lane = data, {}

    def current(self):
        lane = ref_segment._FORCE
        if lane not in self.by_lane:
            ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=1 << 14)
            ref = RefCarnot(device_executor=ex)
            ref.table_store.create_table(
                "http_events", _relation(RefDT, RefRelation, RefST)).write_pydict(dict(self.data))
            self.by_lane[lane] = ref
        return self.by_lane[lane]


@pytest.fixture(scope="module")
def engines():
    data = http_events(N)
    port_ex = DeviceExecutor(device="cpu", block_rows=1 << 14)
    port = Carnot(device_executor=port_ex)
    port.table_store.create_table("http_events", _relation(DataType, Relation, SemanticType)).write_pydict(
        dict(data))
    return data, _RefEngines(data), port


def _run(engines, name: str):
    """(port table, reference table, the reference's fold key, the port's
    lanes) of query ``name``; the reference engine is the one built under
    the current lane."""
    _, refs, port = engines
    ref = refs.current()
    ref.device_executor._program_cache.clear()
    want = ref.execute_query(QUERIES[name], now_ns=NOW).table(name)
    folds = [k for k in ref.device_executor._program_cache if k.startswith("fold|")]
    assert len(folds) == 1 and not ref.device_executor.fallback_errors
    segment.reduce_lanes(reset=True)
    port.device_executor.clear_caches()  # every run cold: one stage_stream lane
    port.device_executor.last_fold_ms = None
    got = port.execute_query(QUERIES[name], now_ns=NOW).table(name)
    assert port.device_executor.last_fold_ms is not None
    return got, want, folds[0], segment.reduce_lanes(reset=True)


def _within_a_bin(got: list, want: list) -> None:
    for g, w in zip(got, want):
        assert abs(g - w) <= (DEFAULT_SPEC.gamma - 1) * max(g, w) * (1 + 1e-9) + 1, (g, w)


def _close(got: list, want: list, rel: float) -> None:
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


@pytest.fixture(params=["matmul", "scatter"])
def ref_lane(request):
    ref_segment.set_strategy(request.param)
    yield request.param
    ref_segment.set_strategy(None)


@pytest.fixture(params=["scatter", None], ids=["scatter", "auto"])
def ref_lane_q4(request):
    """Q4 under the scatter lane and the reference's own choice: a forced
    matmul lane would build count-min's one-hot over 4 x 8192 cells per
    group for every row (~137 GB at this table), which the reference's
    own choice never does."""
    ref_segment.set_strategy(request.param)
    yield request.param
    ref_segment.set_strategy(None)


def test_q1_svc_let_matches_reference(engines, ref_lane):
    data, _, _ = engines
    got, want, fold, lanes = _run(engines, "let")
    assert "hostgids:True" in fold and lanes == {"fold_key_host": 1, "stage_stream": 1}
    assert got["k8s"] == want["k8s"] and got["time_"] == want["time_"]
    assert set(got["k8s"]) == {"svc-1"} | {f"svc-1{i}" for i in range(6)}
    for k in ("latency_p50", "latency_p90", "latency_p99"):
        _within_a_bin(got[k], want[k])
    for k in ("error_rate", "request_throughput", "bytes_throughput"):
        _close(got[k], want[k], 1e-12)
    # Against numpy: the windows of svc-1's rows that pass the filters.
    keep = ((data["req_path"] != "/healthz") & (data["req_path"] != "/readyz")
            & (data["remote_addr"] != "-") & (data["service"] == "svc-1"))
    win = data["time_"][keep] - np.remainder(data["time_"][keep], 10**10)
    t, counts = np.unique(win, return_counts=True)
    rows = [i for i, s in enumerate(got["k8s"]) if s == "svc-1"]
    assert [got["time_"][i] for i in rows] == t.tolist()
    _close([got["request_throughput"][i] for i in rows], counts / 1e10, 1e-15)


def test_q2_code_histogram_matches_reference(engines, ref_lane):
    data, _, _ = engines
    got, want, fold, lanes = _run(engines, "codes")
    assert "hostgids:True" in fold and lanes == {"fold_key_host": 1, "stage_stream": 1}
    assert got == want
    keep = ((data["req_path"] != "/healthz") & (data["req_path"] != "/readyz")
            & (data["remote_addr"] != "-")
            & np.array(["svc-1" in s for s in data["service"]]))
    codes, counts = np.unique(data["resp_status"][keep], return_counts=True)
    assert dict(zip(got["resp_status"], got["count"])) == dict(zip(codes.tolist(), counts.tolist()))


def test_q3_latency_histogram_matches_reference(engines, ref_lane):
    data, _, _ = engines
    got, want, fold, lanes = _run(engines, "lat_hist")
    assert "hostgids:True" in fold and lanes == {"fold_key_host": 1, "stage_stream": 1}
    assert got == want
    keep = ((data["req_path"] != "/healthz") & (data["req_path"] != "/readyz")
            & (data["remote_addr"] != "-")
            & np.array(["svc-1" in s for s in data["service"]]))
    lat = data["latency"][keep]
    bins, counts = np.unique((lat - np.remainder(lat, 5e7)).astype(np.int64), return_counts=True)
    assert dict(zip(got["request_latency"], got["count"])) == dict(zip(bins.tolist(), counts.tolist()))


def test_q4_endpoint_load_matches_reference(engines, ref_lane_q4):
    data, _, _ = engines
    got, want, fold, lanes = _run(engines, "load")
    assert "key:lut:req_path" in fold and "hostgids:False" in fold
    assert lanes == {"fold_key_lut": 1, "arghash": 1, "stage_stream": 1}
    for k in ("endpoint", "n", "clients", "paths", "err_bytes", "ms"):
        assert got[k] == want[k], k
    _close(got["mlog"], want["mlog"], 1e-12)
    endpoints = np.array([p if p in ("/healthz", "/readyz") else p.rsplit("/", 1)[0] + "/{id}"
                          for p in data["req_path"]], dtype=object)
    for i, ep in enumerate(got["endpoint"]):
        x = data["latency"][endpoints == ep]
        ex2 = float(np.mean(x * x))
        assert abs(got["var"][i] - want["var"][i]) <= 4e-12 * ex2
        assert abs(got["sd"][i] - want["sd"][i]) * (got["sd"][i] + want["sd"][i]) <= 4e-12 * ex2
        assert got["n"][i] == len(x)
        assert abs(got["var"][i] - np.var(x)) <= 1e-9 * ex2
        sel = endpoints == ep
        assert got["err_bytes"][i] == int(np.where(data["resp_status"][sel] >= 400,
                                                   data["resp_body_size"][sel], 0).sum())
        assert got["ms"][i] == int(np.floor(x / 1e6).sum())
        cm = json.loads(got["paths"][i])
        _, freq = np.unique(data["req_path"][sel], return_counts=True)
        assert cm["total"] == len(x) and freq.max() <= cm["max_est"] <= len(x)
        truth = len(set(data["remote_addr"][sel]))
        assert abs(got["clients"][i] - truth) <= 0.12 * truth


def test_string_sketches_on_the_host_agg_node_match_reference():
    """A Carnot with no device executor runs Q4 on its host AggNode (states
    on the CPU), whose STRING sketches hash each value's content through the
    dictionary: equal to the reference's host engine."""
    data = http_events(5_000, seed=3)
    ref = RefCarnot()
    ref.table_store.create_table("http_events", _relation(RefDT, RefRelation, RefST)).write_pydict(dict(data))
    port = Carnot(device="cpu")
    port.table_store.create_table("http_events", _relation(DataType, Relation, SemanticType)).write_pydict(dict(data))
    got = port.execute_query(Q4, now_ns=NOW).table("load")
    want = ref.execute_query(Q4, now_ns=NOW).table("load")
    for k in ("endpoint", "n", "clients", "paths", "err_bytes", "ms"):
        assert got[k] == want[k], k
    _close(got["var"], want["var"], 1e-9)


def test_h17_counts_no_launch_on_the_cpu(engines):
    kernels.reset_launches()
    _run(engines, "let")
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# The vis.json variables without defaults, resolved for the compile check.
_ARGS = {
    "px/pods": {"namespace": "pl"}, "px/slow_http_requests": {"namespace": "pl"},
    "px/net_flow_graph": {"namespace": "pl"}, "px/service": {"service": "default/svc-0"},
    "px/pod": {"pod": "default/svc-0-pod-0"}, "px/node": {"node": "node-0"},
    "px/namespace": {"namespace": "default"}, "px/services": {"namespace": "default"},
    "px/mysql_flow_graph": {"namespace": "default"}, "px/pgsql_flow_graph": {"namespace": "default"},
    "px/redis_flow_graph": {"namespace": "default"},
    "px/pod_edge_stats": {"requesting_pod": "pl/a", "responding_pod": "pl/b"},
}
# Tables of the self-telemetry plane (ROADMAP queue 1 item 9).
_LATER_TABLES = {"device_dispatches", "query_spans", "alerts", "engine_metrics",
                 "device_programs", "hbm_usage"}


def test_bundles_fail_only_on_later_slices():
    """Each of the 47 bundled scripts compiles on the port, or fails on a
    name that ROADMAP queue 1 item 2 or a later one ports (metadata, UDTFs,
    self-telemetry tables): never on a builtin this slice ported."""
    import re

    from pixie_tpu.ingest import http_gen, perf_profiler, proc_stats, socket_tracer, stirling_error

    rels = {"http_events": http_gen.HTTP_EVENTS_REL, "conn_stats": http_gen.CONN_STATS_REL,
            "stack_traces.beta": perf_profiler.STACK_TRACES_REL,
            "process_stats": proc_stats.PROCESS_STATS_REL,
            "network_stats": proc_stats.NETWORK_STATS_REL, "dns_events": socket_tracer.DNS_EVENTS_REL,
            "mysql_events": socket_tracer.MYSQL_EVENTS_REL, "pgsql_events": socket_tracer.PGSQL_EVENTS_REL,
            "redis_events": socket_tracer.REDIS_EVENTS_REL,
            "stirling_error": stirling_error.STIRLING_ERROR_REL}
    rmap = {k: Relation.of(*[(c.name, DataType[c.data_type.name], SemanticType[c.semantic_type.name])
                             for c in r]) for k, r in rels.items()}
    port = Carnot()
    lib = ScriptLibrary()
    compiled, failed = [], {}
    for name in lib.names():
        script = lib.load(name)
        args = {k: v for k, v in _ARGS.get(name, {}).items()
                if any(var["name"] == k for var in script.variables)}
        funcs = [FuncToExecute(f.name, f.args, f.output_table) for f in script.exec_funcs(args)]
        try:
            port.compiler.compile(script.pxl, rmap, exec_funcs=funcs, now_ns=NOW)
            compiled.append(name)
        except Exception as e:  # noqa: BLE001 - the message is the check
            failed[name] = str(e)
    assert len(compiled) + len(failed) == 47 and "px/network_stats" in compiled
    for name, msg in failed.items():
        m = re.search(r"(?:px\.)?(\w+)(?:\([A-Z0-9, ]*\))? is not ported yet", msg)
        t = re.search(r"table '([\w.]+)' does not exist", msg)
        assert m or t, (name, msg)
        if m:
            assert m.group(1) in NOT_PORTED, (name, msg)
        else:
            assert t.group(1) in _LATER_TABLES, (name, msg)
