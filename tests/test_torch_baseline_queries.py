"""The third slice end to end: BASELINE config 1 (px/http_data: filter,
project, head(1000) over http_small), config 0 (the same query without the
head, on both packages' host engines), config 4 (px/perf_flamegraph:
groupby(stack_trace_id) with any(stack_trace) and sum(count)), plain and
filtered, and the px/net_flow_graph min/max aggregate over conn_flows, all
verbatim from bench.py or net_flow_graph.pxl, through the port's Carnot +
DeviceExecutor(device="cpu") against the reference's Carnot + MeshExecutor on
a one-device CPU mesh, over the same numpy tables.

Every column is held exactly, groups in the same order, and the reference
must have taken its device lane (the scan program, the host any() lane, the
fold) with no fallback. One exception is pinned (Fault-6, PERF.md): inside
its jitted scan program XLA-CPU computes ``latency / 1e6`` as ``latency *
(1 / 1e6)``, one ulp off the quotient on about 29% of rows; the port
divides as IEEE division does (numpy, both host engines, config 0), so its
``latency_ms`` is numpy's quotient bit for bit and the reference's is the
reciprocal product bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.table.column import DictColumn as RefDictColumn
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.types import DataType, Relation, SemanticType

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

N_SERVICES = 16
N_STACKS = 4096
N_PODS = 64
# bench.py:856-863, :769-776; net_flow_graph.pxl:46-51 keyed as bench.py's
# config 3 keys conn_flows.
HTTP_DATA = (
    "df = px.DataFrame(table='http_small')\n"
    "df = df[df.resp_status >= 400]\n"
    "df.latency_ms = df.latency / 1000000.0\n"
    "df = df[['time_', 'service', 'latency_ms']]\n"
    "df = df.head(1000)\n"
    "px.display(df, 'out')\n"
)
FLAMEGRAPH = (
    "df = px.DataFrame(table='stacks')\n"
    "s = df.groupby(['stack_trace_id']).agg(\n"
    "    stack_trace=('stack_trace', px.any),\n"
    "    count=('count', px.sum),\n"
    ")\n"
    "px.display(s, 'merged')\n"
)
FLAMEGRAPH_FILTERED = FLAMEGRAPH.replace(
    "df = px.DataFrame(table='stacks')\n",
    "df = px.DataFrame(table='stacks')\ndf = df[df.count > 50]\n",
)
FLOW_SPAN = (
    "df = px.DataFrame(table='conn_flows')\n"
    "s = df.groupby(['src', 'dst']).agg(\n"
    "    bytes_sent_min=('bytes_sent', px.min),\n"
    "    bytes_sent_max=('bytes_sent', px.max),\n"
    "    bytes_recv_min=('bytes_recv', px.min),\n"
    "    bytes_recv_max=('bytes_recv', px.max),\n"
    ")\n"
    "px.display(s, 'flow_span')\n"
)


def http_data_host(n_host: int) -> str:
    """bench.py:887-894, config 0: no head(), a pinned time window."""
    return (
        f"df = px.DataFrame(table='http_small', start_time=0, end_time={n_host * 1000})\n"
        "df = df[df.resp_status >= 400]\n"
        "df.latency_ms = df.latency / 1000000.0\n"
        "df = df[['time_', 'service', 'latency_ms']]\n"
        "px.display(df, 'out')\n"
    )


def http_small(n: int) -> dict:
    """bench.py's build_small (seed 44): 16 services, status {200: .9,
    404: .05, 500: .05}, exponential(3e7) latency."""
    rng = np.random.default_rng(44)
    svc = rng.integers(0, N_SERVICES, n, dtype=np.uint8)
    cum = np.cumsum([0.9, 0.05, 0.05])
    status = np.array([200, 404, 500], np.uint16)[np.searchsorted(cum, rng.random(n), side="right")]
    return {"table": "http_small", "svc": svc, "status": status,
            "latency": rng.exponential(3e7, n)}


def stacks(n: int) -> dict:
    """bench.py's build_stacks (seed 43): 4096 stack ids, counts in [1, 100)."""
    rng = np.random.default_rng(43)
    return {"table": "stacks",
            "sid": rng.integers(0, N_STACKS, n, dtype=np.uint16),
            "cnt": rng.integers(1, 100, n, dtype=np.uint8)}


def conn_flows(n: int) -> dict:
    """bench.py's build_flows (seed 45): 64 pods each side."""
    rng = np.random.default_rng(45)
    return {"table": "conn_flows",
            "src": rng.integers(0, N_PODS, n, dtype=np.uint8),
            "dst": rng.integers(0, N_PODS, n, dtype=np.uint8),
            "remote_port": rng.integers(1024, 65535, n, dtype=np.uint16),
            "bytes_sent": rng.integers(0, 1 << 20, n, dtype=np.uint32),
            "bytes_recv": rng.integers(0, 1 << 20, n, dtype=np.uint32)}


def _fill(store, data: dict, dict_column, dt, relation_of, st) -> None:
    """The tables as bench.py writes them: identity dictionary codes."""
    name = data["table"]
    if name == "http_small":
        n = len(data["svc"])
        rel = relation_of(
            ("time_", dt.TIME64NS, st.ST_TIME_NS),
            ("service", dt.STRING, st.ST_SERVICE_NAME),
            ("resp_status", dt.INT64),
            ("latency", dt.FLOAT64, st.ST_DURATION_NS),
        )
        t = store.create_table(name, rel)
        d = t.dictionaries["service"]
        for i in range(N_SERVICES):
            d.get_code(f"ns/svc-{i}")
        t.write_pydict({
            "time_": np.arange(n, dtype=np.int64) * 1000,
            "service": dict_column(data["svc"].astype(np.int32), d),
            "resp_status": data["status"],
            "latency": data["latency"],
        })
    elif name == "stacks":
        n = len(data["sid"])
        rel = relation_of(
            ("time_", dt.TIME64NS, st.ST_TIME_NS), ("stack_trace_id", dt.INT64),
            ("stack_trace", dt.STRING), ("count", dt.INT64),
        )
        t = store.create_table(name, rel)
        d = t.dictionaries["stack_trace"]
        for i in range(N_STACKS):
            d.get_code(f"main;f{i % 61};g{i % 127};h{i}")
        t.write_pydict({
            "time_": np.arange(n, dtype=np.int64) * 1000,
            "stack_trace_id": data["sid"],
            "stack_trace": dict_column(data["sid"].astype(np.int32), d),
            "count": data["cnt"],
        })
    else:
        n = len(data["src"])
        rel = relation_of(
            ("time_", dt.TIME64NS, st.ST_TIME_NS), ("src", dt.STRING), ("dst", dt.STRING),
            ("remote_port", dt.INT64), ("bytes_sent", dt.INT64), ("bytes_recv", dt.INT64),
        )
        t = store.create_table(name, rel)
        for col in ("src", "dst"):
            for i in range(N_PODS):
                t.dictionaries[col].get_code(f"default/pod-{i}")
        cols = {k: v for k, v in data.items() if k != "table"}
        for col in ("src", "dst"):
            cols[col] = dict_column(data[col].astype(np.int32), t.dictionaries[col])
        t.write_pydict({"time_": np.arange(n, dtype=np.int64) * 1000, **cols})


def run_port(data: dict, query: str, name: str, block_rows: int) -> tuple[dict, DeviceExecutor]:
    ex = DeviceExecutor(device="cpu", block_rows=block_rows)
    port = Carnot(device_executor=ex)
    _fill(port.table_store, data, DictColumn, DataType, Relation.of, SemanticType)
    return port.execute_query(query).table(name), ex


def run_ref(data: dict, query: str, name: str, block_rows: int) -> tuple[dict, MeshExecutor]:
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=block_rows)
    ref = RefCarnot(device_executor=ex)
    _fill(ref.table_store, data, RefDictColumn, RefDT, RefRelation.of, RefST)
    out = ref.execute_query(query).table(name)
    assert not ex.fallback_errors
    return out, ex


def assert_scan_matches(got: dict, want: dict, data: dict) -> None:
    """Rows, order, time_ and service exact; latency_ms under Fault-6."""
    if not want:  # no row survived: both results hold no column
        assert got == want
        return
    assert got["time_"] == want["time_"] and got["service"] == want["service"]
    lat = data["latency"][np.asarray(got["time_"], dtype=np.int64) // 1000]
    g, w = np.asarray(got["latency_ms"]), np.asarray(want["latency_ms"])
    assert np.array_equal(g.view(np.int64), (lat / 1e6).view(np.int64))
    assert np.array_equal(w.view(np.int64), (lat * (1 / 1e6)).view(np.int64))
    assert np.abs(g.view(np.int64) - w.view(np.int64)).max(initial=0) <= 1


def test_config1_http_data_matches_reference():
    """Filter, project, head(1000): 4096-row blocks, so the limit ends inside
    the third block; the reference ran its scan program."""
    kernels.reset_launches()
    data = http_small(200_000)
    got, ex = run_port(data, HTTP_DATA, "out", 1 << 12)
    want, ref_ex = run_ref(data, HTTP_DATA, "out", 1 << 12)
    assert any(k.startswith("scan|") for k in ref_ex._program_cache)
    assert ex.last_fold_ms is not None  # the port's scan lane ran
    assert_scan_matches(got, want, data)
    assert got["latency_ms"] != want["latency_ms"]  # Fault-6 shows here
    sel = np.flatnonzero(data["status"] >= 400)[:1000]
    assert got["time_"] == (sel * 1000).tolist()
    assert got["latency_ms"] == (data["latency"][sel] / 1e6).tolist()
    assert got["service"] == [f"ns/svc-{i}" for i in data["svc"][sel]]
    # On the CPU the plain versions ran: no CUDA kernel was launched.
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize(
    "pred, limit",
    [(">= 500", 5000), (">= 400", 1), ("> 500", 10), (">= 400", 1 << 20)],
    ids=["limit-in-late-block", "limit-1", "no-survivor", "limit-past-survivors"],
)
def test_scan_limits_match_reference(pred, limit):
    """The limit ending in a late block, a limit of 1, no survivor at all,
    and a limit larger than every survivor (the whole table scanned)."""
    data = http_small(60_000)
    query = HTTP_DATA.replace(">= 400", pred).replace("head(1000)", f"head({limit})")
    got, _ = run_port(data, query, "out", 1 << 12)
    want, ref_ex = run_ref(data, query, "out", 1 << 12)
    assert any(k.startswith("scan|") for k in ref_ex._program_cache)
    assert_scan_matches(got, want, data)


def test_config0_host_engines_match():
    """Config 0 has no head(): both packages run it on their host engines."""
    data = http_small(50_000)
    query = http_data_host(30_000)
    got, ex = run_port(data, query, "out", 1 << 12)
    want, ref_ex = run_ref(data, query, "out", 1 << 12)
    assert ex.last_fold_ms is None and not ref_ex._program_cache
    assert got == want
    assert len(got["time_"]) == int((data["status"][:30_000] >= 400).sum())


def test_config4_flamegraph_matches_reference():
    """any(stack_trace) takes the host lane in both packages; the stack sums
    fold on the device."""
    data = stacks(200_000)
    got, ex = run_port(data, FLAMEGRAPH, "merged", 1 << 14)
    want, ref_ex = run_ref(data, FLAMEGRAPH, "merged", 1 << 14)
    assert len(ref_ex._hostany_cache) == 1 and len(ex._hostany_cache) == 1
    assert got == want
    sids = np.asarray(got["stack_trace_id"])
    assert len(sids) == N_STACKS
    sums = np.bincount(data["sid"], weights=data["cnt"], minlength=N_STACKS).astype(np.int64)
    assert got["count"] == sums[sids].tolist()
    assert got["stack_trace"] == [f"main;f{i % 61};g{i % 127};h{i}" for i in sids]
    ex.clear_caches()
    assert not ex._hostany_cache


def test_config4_filtered_any_folds_on_device_and_matches_reference():
    """With a predicate any() folds on the device as the max of the codes
    (H11 on the card); the reference takes its device lane too."""
    data = stacks(200_000)
    got, ex = run_port(data, FLAMEGRAPH_FILTERED, "merged", 1 << 14)
    want, ref_ex = run_ref(data, FLAMEGRAPH_FILTERED, "merged", 1 << 14)
    assert not ref_ex._hostany_cache and not ex._hostany_cache
    assert got == want
    assert got["stack_trace"] == [
        f"main;f{i % 61};g{i % 127};h{i}" for i in got["stack_trace_id"]
    ]


def test_flow_span_min_max_matches_reference():
    data = conn_flows(200_000)
    got, _ = run_port(data, FLOW_SPAN, "flow_span", 1 << 14)
    want, ref_ex = run_ref(data, FLOW_SPAN, "flow_span", 1 << 14)
    assert ref_ex.last_fold_ms is not None
    assert got == want
    assert len(got["src"]) == N_PODS * N_PODS
    pod = lambda name: int(name.rsplit("-", 1)[1])
    pair = np.array([pod(a) * N_PODS + pod(b) for a, b in zip(got["src"], got["dst"])])
    flat = data["src"].astype(np.int64) * N_PODS + data["dst"]
    for col in ("bytes_sent", "bytes_recv"):
        lo = np.full(N_PODS * N_PODS, np.iinfo(np.int64).max)
        hi = np.full(N_PODS * N_PODS, np.iinfo(np.int64).min)
        np.minimum.at(lo, flat, data[col].astype(np.int64))
        np.maximum.at(hi, flat, data[col].astype(np.int64))
        assert got[f"{col}_min"] == lo[pair].tolist()
        assert got[f"{col}_max"] == hi[pair].tolist()


def test_flow_span_hands_byte_columns_to_min_max_as_staged(monkeypatch):
    """bytes_sent and bytes_recv (values below 2^20) stage narrowed to
    int32 with their offsets; the fold hands them to all four min and max
    states as segment.Narrow (``_staged_args``), which H11 reads as staged
    on the card, and the result still equals the reference's."""
    from pixie_tpu_torch.ops import segment

    seen = []
    real = segment.segment_minmax

    def spy(state, values, seg_ids, mask, is_min):
        seen.append((type(values), getattr(values, "values", values).dtype, is_min))
        return real(state, values, seg_ids, mask, is_min)

    monkeypatch.setattr(segment, "segment_minmax", spy)
    data = conn_flows(50_000)
    got, ex = run_port(data, FLOW_SPAN, "flow_span", 1 << 14)
    blocks = -(-50_000 // (1 << 14))
    assert len(seen) == 4 * blocks
    assert all(t is segment.Narrow and dt == torch.int32 for t, dt, _ in seen), seen
    assert sum(m for _, _, m in seen) == 2 * blocks
    want, _ = run_ref(data, FLOW_SPAN, "flow_span", 1 << 14)
    assert got == want
