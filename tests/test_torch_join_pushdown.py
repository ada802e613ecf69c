"""The standalone join's pre-join predicate pushdown: the port's
DeviceExecutor on the CPU (one device, and 4 logical shards at
hosts:2,d:2, the partitioned lane) against the reference's MeshExecutor on
the same geometry of its virtual CPU devices and against the host nodes of
both packages, on the same numpy tables.

Each side's predicates are evaluated on the host over the read the keys
came from and select that side's rows by mask, in row order, before the
keys encode and the columns stage (pixie_tpu/parallel/pipeline.py:2905-2985).
Held: INNER and LEFT rows equal the reference's lane and both host nodes
row for row; RIGHT and OUTER rows equal them as a multiset (the host nodes
interleave each probe batch's unmatched rows) and the reference's lane row
for row; the port's lane ran (``join_sort_merge`` or ``join_partitioned``),
never its host node; the side digests equal the reference's
``predicate_fold_digest`` on the same predicates, and a predicate outside
the normalizable class declines to the host node before anything runs.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.distributed import MeshConfig
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.parallel import DeviceExecutor, pipeline
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.utils import flags

# The CPU tests share their host with the reference's timing-sensitive
# tests under several workers: two intra-op threads.
torch.set_num_threads(2)

BLOCK = 256
NDEV = 4
SPECS = ("d:1", "hosts:2,d:2")
JOIN_Q = (
    "l = px.DataFrame(table='dims')\n"
    "r = px.DataFrame(table='facts')\n"
    "{left}"
    "{right}"
    "j = l.merge(r, how='{how}', left_on=['svc'], right_on=['service'], suffixes=['', '_r'])\n"
    "px.display(j, 'joined')\n"
)
# Each predicate shape, on the left side, the right side or both.
PREDICATES = {
    "numeric": ("", "r = r[r.lat > 0.25]\n"),
    "string_eq": ("l = l[l.svc == 's14']\n", ""),
    "string_ne": ("", "r = r[r.service != 's13']\n"),
    "conjunction": ("", "r = r[(r.lat > -0.5) & (r.code != 3)]\n"),
    "in_list": ("l = l[(l.svc == 's13') | (l.svc == 's20') | (l.svc == 's2')]\n", ""),
    "bool_column": ("l = l[l.flag]\n", ""),
    "both_sides": ("l = l[l.rank >= 500000]\nl = l[l.owner < 1.0]\n",
                   "r = r[r.code <= 4]\nr = r[r.lat != 0.0]\n"),
}


@pytest.fixture(autouse=True)
def _join_flags():
    for f in (flags, ref_flags):
        f.set("device_join_min_rows", 1)
    yield
    for f in (flags, ref_flags):
        f.reset("device_join_min_rows")


def _fill(carnot, pkg: str, nl=600, nr=900, seed=3, kl=24, kr=30, chunks=3) -> None:
    """tests/test_torch_mesh_join.py's dims and facts (the facts in
    ``chunks`` writes: several probe batches on the host nodes)."""
    dt, rel = (RefDT, RefRelation) if pkg == "ref" else (DataType, Relation)
    rng = np.random.default_rng(seed)
    carnot.table_store.create_table("dims", rel.of(
        ("svc", dt.STRING), ("owner", dt.FLOAT64), ("rank", dt.INT64),
        ("flag", dt.BOOLEAN))).write_pydict({
            "svc": np.array([f"s{i}" for i in rng.integers(0, kl, nl)], dtype=object),
            "owner": rng.standard_normal(nl),
            "rank": rng.integers(-5, 2_000_000, nl),
            "flag": rng.random(nl) < 0.5,
        })
    facts = {
        "service": np.array([f"s{i}" for i in rng.integers(kl // 2, kr, nr)], dtype=object),
        "lat": rng.standard_normal(nr),
        "code": rng.integers(0, 7, nr),
    }
    t = carnot.table_store.create_table("facts", rel.of(
        ("service", dt.STRING), ("lat", dt.FLOAT64), ("code", dt.INT64)))
    for part in np.array_split(np.arange(nr), chunks):
        t.write_pydict({k: v[part] for k, v in facts.items()})


def _port(spec, query):
    """(the port's rows, its lanes) on ``spec`` over 4 logical CPU shards
    (d:1: the CPU alone); ``spec`` None: the port's host nodes."""
    if spec is None:
        ex = None
    elif spec == "d:1":
        ex = DeviceExecutor(device="cpu", block_rows=BLOCK)
    else:
        ex = DeviceExecutor(block_rows=BLOCK, mesh_config=MeshConfig.parse(spec, NDEV),
                            devices=["cpu"] * NDEV)
    c = Carnot(device_executor=ex)
    _fill(c, "port")
    segment.reduce_lanes(reset=True)
    return c.execute_query(query).table("joined"), segment.reduce_lanes(reset=True)


def _ref(spec, query):
    """(the reference's rows, its lanes) on the same geometry of its
    virtual CPU devices; ``spec`` None: its host nodes."""
    ex = None
    if spec is not None:
        devs = np.array(jax.devices()[:NDEV if spec != "d:1" else 1])
        cfg = MeshConfig.parse(spec, devs.size)
        ex = MeshExecutor(mesh=Mesh(devs.reshape(cfg.shape), cfg.names), block_rows=BLOCK)
    c = RefCarnot(device_executor=ex)
    _fill(c, "ref")
    ref_segment.reduce_lanes(reset=True)
    rows = c.execute_query(query).table("joined")
    if ex is not None:
        assert not ex.fallback_errors, ex.fallback_errors
    return rows, ref_segment.reduce_lanes(reset=True)


def _rows(table: dict) -> list:
    return sorted(zip(*table.values()), key=repr)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("shape", sorted(PREDICATES))
def test_pushdown_matches_reference_and_host_nodes(shape, how, spec):
    left, right = PREDICATES[shape]
    q = JOIN_Q.format(left=left, right=right, how=how)
    lane = "join_sort_merge" if spec == "d:1" else "join_partitioned"
    got, lanes = _port(spec, q)
    assert lanes == {lane: 1}, lanes
    want, ref_lanes = _ref(spec, q)
    assert ref_lanes.get(lane) == 1, ref_lanes
    host, host_lanes = _port(None, q)
    ref_host = _ref(None, q)[0]
    assert host_lanes == {} and host == ref_host
    assert len(next(iter(got.values()))) > 0
    assert got == want
    if how in ("inner", "left"):
        assert got == host
    else:
        assert _rows(got) == _rows(host)


@pytest.mark.parametrize("spec", SPECS)
def test_pushdown_warm_query_reuses_the_selected_staging(spec):
    """The digest is in each side's staging identity: a second query with
    the same predicates (another order, the same rows) reuses the staged
    sides; other predicates stage anew and keep their own rows."""
    ex = (DeviceExecutor(device="cpu", block_rows=BLOCK) if spec == "d:1" else
          DeviceExecutor(block_rows=BLOCK, mesh_config=MeshConfig.parse(spec, NDEV),
                         devices=["cpu"] * NDEV))
    c = Carnot(device_executor=ex)
    _fill(c, "port")
    a = JOIN_Q.format(left="", right="r = r[r.code <= 4]\nr = r[r.lat > 0.0]\n", how="inner")
    b = JOIN_Q.format(left="", right="r = r[r.lat > 0.0]\nr = r[4 >= r.code]\n", how="inner")
    other = JOIN_Q.format(left="", right="r = r[r.lat > 0.5]\n", how="inner")
    first = c.execute_query(a).table("joined")
    entries = len(ex._staged_cache)
    assert c.execute_query(b).table("joined") == first
    assert len(ex._staged_cache) == entries
    third = c.execute_query(other).table("joined")
    assert len(ex._staged_cache) > entries
    assert third == _port(None, other)[0] and third != first


def test_a_side_with_no_row_left_declines():
    q = JOIN_Q.format(left="", right="r = r[r.lat > 100.0]\n", how="left")
    got, lanes = _port("d:1", q)
    assert lanes == {}
    assert got == _ref(None, q)[0]


def test_row_gate_counts_the_selected_rows():
    """600 + 900 rows read, fewer selected: the gate sees the selected."""
    q = JOIN_Q.format(left="l = l[l.svc == 's14']\n", right="r = r[r.service == 's14']\n",
                      how="inner")
    for f in (flags, ref_flags):
        f.set("device_join_min_rows", 200)
    got, lanes = _port("d:1", q)
    want, ref_lanes = _ref("d:1", q)
    assert lanes == {} and "join_sort_merge" not in ref_lanes
    assert got == want and len(got["svc"]) > 0


def test_predicate_outside_the_class_declines_before_anything_runs(monkeypatch):
    """A float IN-list is outside the normalizable class: no digest, so
    the join declines to the host node without reading or evaluating."""
    q = JOIN_Q.format(left="", right="r = r[(r.lat == 0.5) | (r.lat == 0.25)]\n", how="inner")

    def no_mask(*a, **k):
        raise AssertionError("evaluated a predicate outside the class")

    monkeypatch.setattr(pipeline, "host_pred_mask", no_mask)
    got, lanes = _port("d:1", q)
    assert lanes == {}
    assert got == _ref(None, q)[0]


def _digests(pkg: str, text: str, monkeypatch) -> list:
    """The digests each package's join lane takes of the pre-join
    predicates in ``text`` (on ``l``), recorded around the package's own
    ``predicate_fold_digest`` as a query runs."""
    import pixie_tpu.parallel.pipeline as ref_pipeline

    module = ref_pipeline if pkg == "ref" else pipeline
    real, seen = module.predicate_fold_digest, []

    def record(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(module, "predicate_fold_digest", record)
    q = JOIN_Q.format(left=text, right="", how="inner")
    (_ref if pkg == "ref" else _port)("d:1", q)
    monkeypatch.undo()
    return seen


DIGEST_CASES = [
    "l = l[l.svc == 's3']\n",
    "l = l[l.svc != 'never-seen']\n",
    "l = l[(l.svc == 's3') | (l.svc == 's1') | (l.svc == 's3')]\n",
    "l = l[l.owner > 0.1]\nl = l[l.rank <= 7000]\n",
    "l = l[l.rank <= 7000]\nl = l[l.owner > 0.1]\n",
    "l = l[(l.rank < 900000) & (3 < l.rank)]\n",
    "l = l[l.flag]\n",
    "l = l[l.owner > 1]\n",
    "l = l[(l.owner == 0.5) | (l.owner == 1.5)]\n",  # a float IN-list: outside
    "l = l[px.contains(l.svc, 's1')]\n",  # a host function without a table: outside
]


@pytest.mark.parametrize("text", DIGEST_CASES)
def test_digest_matches_reference(text, monkeypatch):
    got = _digests("port", text, monkeypatch)
    want = _digests("ref", text, monkeypatch)
    assert len(got) == 1 and got == want


def test_equivalent_predicate_lists_share_a_digest(monkeypatch):
    d = [_digests("port", t, monkeypatch)[0] for t in DIGEST_CASES[3:5]]
    assert d[0] is not None and d[0] == d[1]
    one = _digests("port", DIGEST_CASES[0], monkeypatch)[0]
    assert one is not None and "'s3'" in one  # the string by value, not its code
