"""The int-dictionary cell lane of the port (H20 ``hll.cell_update``, H21
``countmin.cell_update_counted`` and the pipeline's lane) against the
reference's (pixie_tpu/ops/hll.py:82, ops/countmin.py:82,
parallel/pipeline.py:5471-5510) and against the port's own row path, on the
same seeded numpy inputs.

Exact, in three comparisons: the plain cell updates against the reference's
cell_update, against the row path (H5's and H6's plain versions over the
rows the histogram counts), and (on the card, tests/test_torch_kernels.py)
H20 and H21 against their plain versions. End to end: config 5's query and
the approx_count_distinct overload through the lane equal the reference's
device lane and the port's row path letter for letter; a filter on the
sketch column keeps the row path in both packages; and the staged-cache key
keeps an exact query off a column staged as sketch codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import countmin as ref_countmin, hll as ref_hll
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import countmin, hll, kernels, segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.parallel.pipeline import CELL_MAX_CELLS
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.utils import flags

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

LUT = np.array([-3, 0, 5, 17, 1 << 40, 999, 12345], np.int64)


def _cells(seed: int, g: int, C: int, n: int = 30_000):
    """(hist [g, C], lut [C], and the rows the histogram counts: gids,
    values, mask)."""
    rng = np.random.default_rng(seed)
    lut = LUT[:C] if C <= len(LUT) else np.unique(rng.integers(-(1 << 50), 1 << 50, C))
    codes = rng.integers(0, len(lut), n)
    gids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    hist = np.zeros((g, len(lut)), np.int64)
    np.add.at(hist, (gids[mask], codes[mask]), 1)
    return hist, lut, gids, lut[codes], mask


SHAPES = [(4, 7), (16, 4), (32, 256), (3, 1)]


@pytest.mark.parametrize("g, C", SHAPES)
def test_hll_cell_update_matches_reference_and_row_path(g, C):
    hist, lut, gids, vals, mask = _cells(g * 1000 + C, g, C)
    start = np.random.default_rng(1).integers(0, 4, (g, 2048)).astype(np.int32)
    got = hll.cell_update(torch.from_numpy(start.copy()), torch.from_numpy(hist),
                          torch.from_numpy(lut))
    want = ref_hll.cell_update(jnp.asarray(start), jnp.asarray(hist), jnp.asarray(lut))
    assert np.array_equal(got.numpy(), np.asarray(want))
    rows = hll.update_plain(torch.from_numpy(start.copy()), torch.from_numpy(gids),
                            torch.from_numpy(vals), torch.from_numpy(mask))
    assert torch.equal(got, rows)


@pytest.mark.parametrize("g, C", SHAPES)
def test_countmin_cell_update_matches_reference_and_row_path(g, C):
    hist, lut, gids, vals, mask = _cells(g * 1000 + C + 1, g, C)
    start = np.random.default_rng(2).integers(0, 9, (g, 4, 8192)).astype(np.int64)
    total0 = np.arange(g, dtype=np.int64)
    cm, total = countmin.cell_update_counted(
        torch.from_numpy(start.copy()), torch.from_numpy(total0.copy()),
        torch.from_numpy(hist), torch.from_numpy(lut))
    want = ref_countmin.cell_update(jnp.asarray(start), jnp.asarray(hist), jnp.asarray(lut))
    assert np.array_equal(cm.numpy(), np.asarray(want))
    assert np.array_equal(total.numpy(), total0 + hist.sum(axis=1))
    rows, rows_total = countmin.update_counted(
        torch.from_numpy(start.copy()), torch.from_numpy(total0.copy()),
        torch.from_numpy(gids), torch.from_numpy(vals), torch.from_numpy(mask))
    assert torch.equal(cm, rows) and torch.equal(total, rows_total)


def _http_events(n: int, seed: int = 42) -> dict:
    rng = np.random.default_rng(seed)
    opts = np.array([200, 301, 404, 500], np.int64)
    status = opts[np.searchsorted(np.cumsum([0.85, 0.05, 0.05, 0.05]), rng.random(n),
                                  side="right")]
    names = np.array([f"ns/svc-{i}" for i in range(16)], dtype=object)
    return {
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": names[rng.integers(0, 16, n)],
        "resp_status": status,
        "latency": rng.exponential(3e7, n),
    }


def _port(data: dict):
    ex = DeviceExecutor(device="cpu", block_rows=1 << 14)
    c = Carnot(device_executor=ex)
    rel = Relation.of(("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
                      ("service", DataType.STRING, SemanticType.ST_SERVICE_NAME),
                      ("resp_status", DataType.INT64), ("latency", DataType.FLOAT64))
    c.table_store.create_table("http_events", rel).write_pydict(dict(data))
    return c, ex


def _ref(data: dict):
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=1 << 14)
    c = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS, RefST.ST_TIME_NS),
                         ("service", RefDT.STRING, RefST.ST_SERVICE_NAME),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    c.table_store.create_table("http_events", rel).write_pydict(dict(data))
    return c, ex


SKETCHES = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    lat=('latency', px.quantiles_tdigest),\n"
    "    freq=('resp_status', px.count_min),\n"
    ")\n"
    "px.display(s, 'sketches')\n"
)
STATUS_MIX = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    kinds=('resp_status', px.approx_count_distinct),\n"
    "    freq=('resp_status', px.count_min),\n"
    ")\n"
    "px.display(s, 'sketches')\n"
)


def _row_path(data: dict, query: str) -> dict:
    """The port with the cell lane's budget at zero: every UDA on its row
    path (H5, H6 on the card)."""
    import pixie_tpu_torch.parallel.pipeline as pipeline

    saved = pipeline.CELL_MAX_CELLS
    pipeline.CELL_MAX_CELLS = 0
    try:
        segment.reduce_lanes(reset=True)
        out = _port(data)[0].execute_query(query).table("sketches")
        assert "cell_lane" not in segment.reduce_lanes(reset=True)
        return out
    finally:
        pipeline.CELL_MAX_CELLS = saved


@pytest.mark.parametrize("query", [SKETCHES, STATUS_MIX], ids=["config5", "status_mix"])
@pytest.mark.parametrize("streaming", [True, False])
def test_cell_lane_queries_match_reference_and_row_path(query, streaming):
    """config 5 and status_mix: resp_status stages as uint8 codes of
    [200, 301, 404, 500] and count-min and HLL fold per cell, in both
    packages; the JSON and the distinct counts equal the reference's and the
    row path's."""
    data = _http_events(60_000)
    flags.set("streaming_stage", streaming)
    try:
        kernels.reset_launches()
        c, ex = _port(data)
        segment.reduce_lanes(reset=True)
        got = c.execute_query(query).table("sketches")
        lanes = segment.reduce_lanes(reset=True)
        (staged,) = ex._staged_cache.values()
        row = _row_path(data, query)
    finally:
        flags.reset("streaming_stage")
    rc, rex = _ref(data)
    want = rc.execute_query(query).table("sketches")
    (ref_staged,) = rex._staged_cache.values()
    assert lanes.get("cell_lane") == 1
    assert lanes.get("stage_stream" if streaming else "stage_monolithic") == 1
    assert list(staged.int_dicts["resp_status"]) == list(ref_staged.int_dicts["resp_status"]) \
        == [200, 301, 404, 500]
    assert staged.blocks["resp_status"].dtype == torch.uint8
    assert got["service"] == want["service"] == row["service"]
    assert got["freq"] == want["freq"] == row["freq"]
    if "kinds" in got:
        assert got["kinds"] == want["kinds"] == row["kinds"]
        assert all(abs(k - 4) <= 0.12 * 4 for k in got["kinds"])
    assert not any(kernels.LAUNCHES.values())  # the plain versions ran


def test_filter_on_the_sketch_column_stays_rowwise():
    """A predicate on the sketch column keeps it off the lane in both
    packages (the histogram could not honour the filter); the JSON equal."""
    data = _http_events(40_000)
    q = SKETCHES.replace("df = px.DataFrame(table='http_events')\n",
                         "df = px.DataFrame(table='http_events')\ndf = df[df.resp_status >= 400]\n")
    c, ex = _port(data)
    segment.reduce_lanes(reset=True)
    got = c.execute_query(q).table("sketches")
    assert "cell_lane" not in segment.reduce_lanes(reset=True)
    rc, rex = _ref(data)
    want = rc.execute_query(q).table("sketches")
    assert got["freq"] == want["freq"]
    assert not next(iter(ex._staged_cache.values())).int_dicts
    assert not next(iter(rex._staged_cache.values())).int_dicts


def test_cell_budget_matches_reference():
    """The reference's bound, max_card = min(256, 8192 // capacity)
    (pixie_tpu/parallel/pipeline.py:4238): none past the budget, and a
    column with any consumer but a cell-capable UDA stays off the lane."""
    from pixie_tpu.ops import segment as ref_segment

    assert CELL_MAX_CELLS == ref_segment.MATMUL_MAX_SEGMENTS == 8192
    _c, ex = _port(_http_events(1000))

    class _M:
        predicates = []
        agg_op = type("A", (), {"groups": []})()
        col_exprs = {}
        source_relation = Relation.of(("resp_status", DataType.INT64),
                                      ("latency", DataType.FLOAT64))

    from pixie_tpu_torch.plan.expressions import ColumnRef
    from pixie_tpu_torch.udf.registry import default_registry

    reg = default_registry()
    cm = reg.lookup_uda("count_min", [DataType.INT64])
    specs = [("f", ColumnRef("resp_status"), cm)]
    assert ex._cell_cols(_M, specs, 16) == {"resp_status": 256}
    assert ex._cell_cols(_M, specs, 64) == {"resp_status": 128}
    assert ex._cell_cols(_M, specs, 8192) == {}
    # A second, non-cell consumer of the column keeps it off the lane.
    s = reg.lookup_uda("sum", [DataType.INT64])
    assert ex._cell_cols(_M, specs + [("t", ColumnRef("resp_status"), s)], 16) == {}


def test_staged_cache_key_keeps_exact_query_off_sketch_codes():
    """A sketch query stages resp_status as codes; an exact sum over the
    same table version must not reuse that staging (the cell columns are
    part of the key): its sum is the column's."""
    data = _http_events(30_000)
    c, ex = _port(data)
    c.execute_query(SKETCHES)
    (coded,) = ex._staged_cache.values()
    assert "resp_status" in coded.int_dicts
    out = c.execute_query(
        "df = px.DataFrame(table='http_events')\n"
        "s = df.groupby(['service']).agg(freq=('resp_status', px.count_min),\n"
        "    total=('resp_status', px.sum))\n"
        "px.display(s, 'o')\n"
    ).table("o")
    assert len(ex._staged_cache) == 2
    assert sum(out["total"]) == int(data["resp_status"].sum())
    again = c.execute_query(SKETCHES).table("sketches")  # still served by the coded entry
    assert len(ex._staged_cache) == 2 and len(again["freq"]) == 16
