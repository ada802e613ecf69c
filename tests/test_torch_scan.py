"""Parity of the scan's stable compaction (``compact_rows_plain``, the plain
version of H12) with the reference's device scan program
(pixie_tpu/parallel/pipeline.py ``_build_scan_program``), run through
MeshExecutor on a one-device CPU mesh.

One table of three 4096-row blocks: about 10% of rows survive the
predicate, the second block has no survivor, and the third block holds 10
rows (all survivors) and 4086 rows of padding. The limits: 0, 1, one that
ends inside the first block, one that ends inside the last block, and one
larger than every survivor. The reference's raw program outputs (its
``written`` and its output buffers) are captured, and the port's blocks,
staged by the port and driven through ``compact_rows_plain``, must give the
same ``written`` and the same selected prefix, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.table.column import DictColumn as RefDictColumn
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import scan
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.parallel.staging import stage_columns
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.types import DataType, Relation

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

B = 1 << 12
N = 2 * B + 10
QUERY = (
    "df = px.DataFrame(table='t')\n"
    "df = df[df.resp_status >= 400]\n"
    "df = df[['time_', 'service', 'latency']]\n"
    "df = df.head({limit})\n"
    "px.display(df, 'out')\n"
)


def _columns() -> dict:
    rng = np.random.default_rng(11)
    status = np.array([200, 404, 500], np.int64)[
        np.searchsorted(np.cumsum([0.9, 0.05, 0.05]), rng.random(N), side="right")
    ]
    status[B : 2 * B] = 200  # the second block: no survivor
    status[2 * B :] = 404  # the padded last block: every real row survives
    return {
        "time_": np.arange(N, dtype=np.int64) * 1000,
        "service": rng.integers(0, 16, N).astype(np.int32),
        "resp_status": status,
        "latency": rng.exponential(3e7, N),
    }


def _reference_program_outputs(cols: dict, limit: int):
    """(written, [time_, service codes, latency] buffers) as the reference's
    scan program returns them."""
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=B)
    ref = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS), ("service", RefDT.STRING),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    t = ref.table_store.create_table("t", rel)
    d = t.dictionaries["service"]
    for i in range(16):
        d.get_code(f"svc-{i}")
    t.write_pydict({**cols, "service": RefDictColumn(cols["service"], d)})
    query = QUERY.format(limit=limit)
    ref.execute_query(query)
    (sig,) = [k for k in ex._program_cache if k.startswith("scan|")]
    program, nargs, extra = ex._program_cache[sig]
    captured = []
    ex._program_cache[sig] = (lambda *a: captured.append(program(*a)) or captured[-1],
                              nargs, extra)
    ref.execute_query(query)
    assert not ex.fallback_errors and len(captured) == 1
    outs = [np.asarray(o) for o in captured[0]]
    return int(outs[0][0]), outs[1:]


def _port_compaction(cols: dict, limit: int, compact=scan.compact_rows_plain):
    staged = stage_columns(cols, N, "cpu", block_rows=B)
    assert staged.num_blocks == 3 and staged.block_rows == B
    written = torch.zeros(1, dtype=torch.int32)
    bufs = [torch.zeros(limit, dtype=dt) for dt in (torch.int64, torch.int32, torch.float64)]
    for blk in range(staged.num_blocks):
        env = DeviceExecutor._block_env(staged, blk)
        mask = staged.mask[0, blk] & (env["resp_status"] >= 400)
        vals = [env["time_"], env["service"].to(torch.int32), env["latency"]]
        compact(mask, vals, written, bufs, limit)
    return int(written[0]), [b.numpy() for b in bufs]


@pytest.mark.parametrize("limit", [0, 1, 100, 399, 10_000],
                         ids=["limit-0", "limit-1", "in-first-block", "in-padded-block",
                              "past-every-survivor"])
def test_compact_rows_plain_matches_reference_program(limit):
    cols = _columns()
    survivors = np.flatnonzero(cols["resp_status"] >= 400)
    # 394 survivors in the first block, 10 in the last: 399 ends in the last.
    assert np.sum(survivors < B) == 394 and survivors.size == 404
    w_ref, bufs_ref = _reference_program_outputs(cols, limit)
    w, bufs = _port_compaction(cols, limit)
    assert w == w_ref == min(limit, survivors.size)
    for got, want in zip(bufs, bufs_ref):
        assert np.array_equal(got[:w], want[:w])
    assert np.array_equal(bufs[0][:w], survivors[:w] * 1000)
    assert np.array_equal(bufs[2][:w].view(np.int64), cols["latency"][survivors[:w]].view(np.int64))


def test_compact_rows_on_cpu_is_the_plain_version():
    cols = _columns()
    w, bufs = _port_compaction(cols, 399, scan.compact_rows)
    w2, bufs2 = _port_compaction(cols, 399)
    assert w == 399
    assert w == w2 and all(np.array_equal(a, b) for a, b in zip(bufs, bufs2))


def test_scan_lane_edge_limits_match_numpy():
    """The port's scan lane end to end on the same table: head(0) to past
    every survivor, strings back through the table's dictionary."""
    cols = _columns()
    survivors = np.flatnonzero(cols["resp_status"] >= 400)
    port = Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=B))
    rel = Relation.of(("time_", DataType.TIME64NS), ("service", DataType.STRING),
                      ("resp_status", DataType.INT64), ("latency", DataType.FLOAT64))
    t = port.table_store.create_table("t", rel)
    d = t.dictionaries["service"]
    for i in range(16):
        d.get_code(f"svc-{i}")
    t.write_pydict({**cols, "service": DictColumn(cols["service"], d)})
    for limit in (0, 1, 100, 399, 10_000):
        got = port.execute_query(QUERY.format(limit=limit)).table("out")
        sel = survivors[:limit]
        if not sel.size:
            assert got == {}
            continue
        assert got["time_"] == (sel * 1000).tolist()
        assert got["service"] == [f"svc-{i}" for i in cols["service"][sel]]
        assert got["latency"] == cols["latency"][sel].tolist()


def _port_table(carnot) -> None:
    cols = _columns()
    rel = Relation.of(("time_", DataType.TIME64NS), ("service", DataType.STRING),
                      ("resp_status", DataType.INT64), ("latency", DataType.FLOAT64))
    t = carnot.table_store.create_table("t", rel)
    t.write_pydict({**cols, "service": DictColumn(cols["service"], t.dictionaries["service"])})


def test_scan_lane_bool_projection_matches_reference():
    """A BOOLEAN projection, carried through H12 as int32 0/1."""
    cols = _columns()
    query = (
        "df = px.DataFrame(table='t')\n"
        "df = df[df.resp_status >= 400]\n"
        "df.fatal = df.resp_status >= 500\n"
        "df = df[['time_', 'fatal']]\n"
        "df = df.head(300)\n"
        "px.display(df, 'out')\n"
    )
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=B)
    ref = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS), ("service", RefDT.STRING),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    t = ref.table_store.create_table("t", rel)
    t.write_pydict({**cols, "service": RefDictColumn(cols["service"], t.dictionaries["service"])})
    want = ref.execute_query(query).table("out")
    assert any(k.startswith("scan|") for k in ex._program_cache) and not ex.fallback_errors
    port_ex = DeviceExecutor(device="cpu", block_rows=B)
    port = Carnot(device_executor=port_ex)
    _port_table(port)
    got = port.execute_query(query).table("out")
    assert port_ex.last_fold_ms is not None
    assert got == want and len(got["time_"]) == 300 and 0 < sum(got["fatal"]) < 300


def test_scan_lane_constant_projection_matches_host_graph():
    """A constant column is a scalar broadcast over the block. (The
    reference's scan program cannot cast a Python scalar and sends such a
    query to its host engine; the port's host graph is the comparand.)"""
    query = (
        "df = px.DataFrame(table='t')\n"
        "df = df[df.resp_status >= 400]\n"
        "df.one = 1\n"
        "df = df[['time_', 'one']]\n"
        "df = df.head(300)\n"
        "px.display(df, 'out')\n"
    )
    port_ex = DeviceExecutor(device="cpu", block_rows=B)
    port, host = Carnot(device_executor=port_ex), Carnot()
    _port_table(port)
    _port_table(host)
    got = port.execute_query(query).table("out")
    assert port_ex.last_fold_ms is not None
    assert got == host.execute_query(query).table("out") and got["one"] == [1] * 300



def test_constant_projection_host_graph_matches_reference_host_engine():
    """Fault-10's chain to the reference: the port's host graph (a Carnot
    with no device executor), which the scan lane's constant projection is
    held against above, equals the reference's host engine for the same
    query, every column and row."""
    query = (
        "df = px.DataFrame(table='t')\n"
        "df = df[df.resp_status >= 400]\n"
        "df.one = 1\n"
        "df = df[['time_', 'one']]\n"
        "df = df.head(300)\n"
        "px.display(df, 'out')\n"
    )
    cols = _columns()
    ref = RefCarnot(device_executor=None)
    rel = RefRelation.of(("time_", RefDT.TIME64NS), ("service", RefDT.STRING),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    t = ref.table_store.create_table("t", rel)
    t.write_pydict({**cols, "service": RefDictColumn(cols["service"], t.dictionaries["service"])})
    host = Carnot()
    _port_table(host)
    want = ref.execute_query(query).table("out")
    got = host.execute_query(query).table("out")
    assert got == want and len(got["time_"]) == 300 and got["one"] == [1] * 300