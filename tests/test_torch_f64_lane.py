"""The fold's moment lane end to end: sum over FLOAT64, mean, variance and
stddev declare their rows (``UDA.moment_rows``), the fold sums every f64 row
of a block in ONE f64 segment sum (H2's plain version here; each (column,
op) once, so stddev and variance of one column share theirs), mean's bool
predicate goes into the fused-sum lane's int launch (H1's), and every
count is that launch's presence row. Through the port's Carnot +
DeviceExecutor(device="cpu") against the reference's Carnot +
MeshExecutor on a one-device CPU mesh, over the same numpy table.

Held: groups, counts, integer sums and the mean of a bool predicate
exactly (a block's count of trues is below 2^53, so its f64 value is the
reference's f64 sum of 0/1 bit for bit); f64 sums within 1e-12 * sum |v|
of math.fsum over the group (Fault-17), means within that bound over the
count; variance within 4e-12 * E[x^2] of the reference's on the same group
(stddev correspondingly). The structural checks wrap the segment entry
points with counters: one int launch and one f64 launch a block, and no
seg_count or seg_sum from the moment UDAs. The comparisons run under both
of the reference's segment lanes (``segment.set_strategy``); the full
endpoint query (its count-min's one-hot is too large for a forced matmul
lane, ROADMAP) under the scatter lane and the reference's own choice.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.types import DataType, Relation, SemanticType

from test_torch_let_queries import NOW, Q4, _relation, http_events

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

N = 30_000
BLOCK_ROWS = 1 << 13
# endpoint_load's moment aggregates (chip_smoke.py ENDPOINT_LOAD without its
# sketches), an f64 sum and service_stats' mean of a bool predicate.
MOMENTS = (
    "df = px.DataFrame(table='http_events', start_time='-15m')\n"
    "df.endpoint = px.regex_replace('/[0-9]+', df.req_path, '/{id}')\n"
    "df.err_bytes = px.select(df.resp_status >= 400, df.resp_body_size, 0)\n"
    "df.log_lat = px.log10(df.latency)\n"
    "df.lat_ms = px.floor(df.latency / 1000000.0)\n"
    "df.failure = df.resp_status >= 400\n"
    "s = df.groupby('endpoint').agg(\n"
    "    n=('latency', px.count),\n"
    "    sd=('latency', px.stddev),\n"
    "    var=('latency', px.variance),\n"
    "    err_bytes=('err_bytes', px.sum),\n"
    "    mlog=('log_lat', px.mean),\n"
    "    ms=('lat_ms', px.sum),\n"
    "    lat=('latency', px.sum),\n"
    "    err_rate=('failure', px.mean),\n"
    ")\n"
    "px.display(s, 'load')\n"
)
ERROR_RATE = (
    "df = px.DataFrame(table='http_events', start_time='-15m')\n"
    "df.failure = df.resp_status >= 400\n"
    "s = df.groupby('service').agg(\n"
    "    throughput=('time_', px.count),\n"
    "    error_rate=('failure', px.mean),\n"
    ")\n"
    "px.display(s, 'rate')\n"
)


@pytest.fixture(scope="module")
def engines():
    """(the table, the port's Carnot). The reference's engine is built anew
    for each query (``_reference``): one built under one segment lane keeps
    serving that lane's sums after the lane is switched."""
    data = http_events(N, seed=5)
    port = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=BLOCK_ROWS))
    port.table_store.create_table(
        "http_events", _relation(DataType, Relation, SemanticType)).write_pydict(dict(data))
    return data, port


def _reference(data: dict):
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=BLOCK_ROWS)
    ref = RefCarnot(device_executor=ex)
    ref.table_store.create_table("http_events", _relation(RefDT, RefRelation, RefST)).write_pydict(
        dict(data))
    return ref


@pytest.fixture(params=["matmul", "scatter"])
def strategy(request):
    ref_segment.set_strategy(request.param)
    yield request.param
    ref_segment.set_strategy(None)


class _Calls:
    """Counting wrappers of the segment entry points the fold and the UDAs
    reach: the rows of each fused and f64 call, and the calls of seg_count
    and seg_sum; and the fold's blocks (``_run_block``)."""

    def __init__(self, monkeypatch, executor):
        self.fused, self.f64, self.count, self.sum, self.blocks = [], [], 0, 0, 0
        fused, f64 = segment.fused_segment_sums, segment.f64_segment_sums
        seg_count, seg_sum = segment.seg_count, segment.seg_sum
        run_block = executor._run_block

        def fused_w(rows, *a, **k):
            self.fused.append(list(rows))
            return fused(rows, *a, **k)

        def f64_w(rows, *a, **k):
            self.f64.append(list(rows))
            return f64(rows, *a, **k)

        def count_w(*a, **k):
            self.count += 1
            return seg_count(*a, **k)

        def sum_w(*a, **k):
            self.sum += 1
            return seg_sum(*a, **k)

        def block_w(*a, **k):
            self.blocks += 1
            return run_block(*a, **k)

        monkeypatch.setattr(segment, "fused_segment_sums", fused_w)
        monkeypatch.setattr(segment, "f64_segment_sums", f64_w)
        monkeypatch.setattr(segment, "seg_count", count_w)
        monkeypatch.setattr(segment, "seg_sum", sum_w)
        monkeypatch.setattr(executor, "_run_block", block_w)


def _run(engines, query: str, name: str, monkeypatch):
    """(port table, reference table, the port's calls) of one query, the
    port's caches dropped first."""
    data, port = engines
    ref = _reference(data)
    want = ref.execute_query(query, now_ns=NOW).table(name)
    assert not ref.device_executor.fallback_errors
    port.device_executor.clear_caches()
    calls = _Calls(monkeypatch, port.device_executor)
    got = port.execute_query(query, now_ns=NOW).table(name)
    monkeypatch.undo()
    assert port.device_executor.last_fold_ms is not None
    return got, want, calls


def _endpoints(data: dict) -> np.ndarray:
    return np.array([p if p in ("/healthz", "/readyz") else p.rsplit("/", 1)[0] + "/{id}"
                     for p in data["req_path"]], dtype=object)


def _hold_moments(got: dict, want: dict, data: dict, lane: float = 0.0) -> None:
    """The moment outputs of one endpoint-keyed table against numpy (the
    Fault-17 bound) and the reference (the bound plus ``lane``, its own
    lane's bound relative to sum |v|: the matmul lane adds f32 parts in
    chunks of _F64_CHUNK rows)."""
    endpoints = _endpoints(data)
    assert got["endpoint"] == want["endpoint"]
    for k in ("n", "err_bytes", "ms"):
        assert got[k] == want[k], k
    for i, ep in enumerate(got["endpoint"]):
        sel = endpoints == ep
        x = data["latency"][sel]
        assert got["n"][i] == x.size
        bound = 1e-12 * math.fsum(np.abs(x))
        assert abs(got["lat"][i] - math.fsum(x)) <= bound
        assert abs(got["lat"][i] - want["lat"][i]) <= 2 * bound + lane * math.fsum(np.abs(x))
        lg = np.log10(x)
        assert abs(got["mlog"][i] - math.fsum(lg) / x.size) <= 1e-12 * math.fsum(np.abs(lg)) / x.size
        ex2 = float(np.mean(x * x))
        assert abs(got["var"][i] - want["var"][i]) <= (4e-12 + 4 * lane) * ex2
        assert abs(got["sd"][i] - want["sd"][i]) * (got["sd"][i] + want["sd"][i]) \
            <= (4e-12 + 4 * lane) * ex2
        assert abs(got["var"][i] - np.var(x)) <= 1e-9 * ex2
        if "err_rate" in got:
            assert got["err_rate"][i] == want["err_rate"][i]
            assert got["err_rate"][i] == np.count_nonzero(data["resp_status"][sel] >= 400) / x.size


def test_moment_fold_matches_reference(engines, strategy, monkeypatch):
    """endpoint_load's moment aggregates, an f64 sum and a mean of a bool
    predicate: one int launch (count's presence row, the two integer sums,
    the bool predicate) and one f64 launch (latency, its squares, log_lat)
    a block; no seg_count, no seg_sum."""
    data, _ = engines
    got, want, calls = _run(engines, MOMENTS, "load", monkeypatch)
    _hold_moments(got, want, data,
                  ref_segment._F64_CHUNK * 2.0**-24 if strategy == "matmul" else 0.0)
    assert calls.blocks >= 3
    assert len(calls.fused) == calls.blocks and len(calls.f64) == calls.blocks
    assert calls.count == 0 and calls.sum == 0
    for rows in calls.fused:
        assert sum(r is segment.PRESENCE for r in rows) == 1 and len(rows) == 4
        assert sum(isinstance(r, torch.Tensor) and r.dtype == torch.bool for r in rows) == 1
    for rows in calls.f64:
        # sd, var, the f64 sum share latency's value row; sd, var its squares
        assert len(rows) == 3 and sorted(r.square for r in rows) == [False, False, True]
        assert all(r.values.dtype == torch.float64 for r in rows)


def test_mean_of_bool_is_exact(engines, strategy, monkeypatch):
    """service_stats' error rate: the predicate's trues counted in the int
    launch beside count's presence row, no f64 launch, equal to the
    reference bit for bit."""
    data, _ = engines
    got, want, calls = _run(engines, ERROR_RATE, "rate", monkeypatch)
    assert got == want
    assert calls.f64 == [] and calls.count == 0 and calls.sum == 0
    assert len(calls.fused) == calls.blocks >= 3
    assert all(len(rows) == 2 for rows in calls.fused)
    keep = data["time_"] >= NOW - 15 * 60 * 10**9
    for i, svc in enumerate(got["service"]):
        sel = keep & (data["service"] == svc)
        assert got["throughput"][i] == np.count_nonzero(sel)
        assert got["error_rate"][i] == np.count_nonzero(data["resp_status"][sel] >= 400) / np.count_nonzero(sel)


@pytest.fixture(params=["scatter", None], ids=["scatter", "auto"])
def ref_lane_q4(request):
    ref_segment.set_strategy(request.param)
    yield request.param
    ref_segment.set_strategy(None)


def test_endpoint_load_launches_one_of_each_a_block(engines, ref_lane_q4, monkeypatch):
    """endpoint_load itself (Q4, its sketches too): one int launch of three
    rows and one f64 launch of three rows a block; the moment outputs as
    above."""
    data, _ = engines
    got, want, calls = _run(engines, Q4, "load", monkeypatch)
    for k in ("n", "clients", "paths", "err_bytes", "ms"):
        assert got[k] == want[k], k
    got["lat"] = want["lat"] = [math.fsum(data["latency"][_endpoints(data) == ep])
                                for ep in got["endpoint"]]
    _hold_moments(got, want, data)
    assert len(calls.fused) == len(calls.f64) == calls.blocks >= 3
    assert calls.count == 0 and calls.sum == 0
    assert all(len(rows) == 3 for rows in calls.fused + calls.f64)


def test_host_agg_node_moments_match_reference():
    """The host AggNode (no device executor) updates through the UDAs' own
    update: mean of a bool predicate in one int launch, variance's two f64
    rows in one f64 launch."""
    data = http_events(4_000, seed=6)
    ref = RefCarnot()
    ref.table_store.create_table("http_events", _relation(RefDT, RefRelation, RefST)).write_pydict(
        dict(data))
    port = Carnot(device="cpu")
    port.table_store.create_table(
        "http_events", _relation(DataType, Relation, SemanticType)).write_pydict(dict(data))
    got = port.execute_query(MOMENTS, now_ns=NOW).table("load")
    want = ref.execute_query(MOMENTS, now_ns=NOW).table("load")
    _hold_moments(got, want, data)
