"""The partitioned sort-merge join over a ``hosts`` axis (K15's rest): the
port's DeviceExecutor over 8 logical CPU shards against the reference's
MeshExecutor on its 8 virtual CPU devices (its partitioned lane) and its
host EquijoinNode, on the same numpy tables.

Held exactly: the rows and their order for INNER, LEFT, RIGHT and OUTER at
hosts:2,d:4 and hosts:4,d:2, with shards that hold no key, with a
two-column key, over distinct devices; the replicated lane when
``mesh_distributed_join`` is off; the partitioned staging's shards, mask,
gids and offsets against the reference's ``stage_partitioned``, and shard
i of each lane on the mesh's device i. STRING columns with outer-null
rows compare decoded (the reference's partitioned lane returns an object
array with "" there, the port a re-encoded dictionary column, PERF.md).
"""

import numpy as np
import pytest
import torch

from pixie_tpu.distributed.mesh import MeshConfig as RefMeshConfig
from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.parallel import staging as ref_staging
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.distributed import MeshConfig
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.parallel import DeviceExecutor, staging
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.utils import flags

# The CPU tests share their host with the reference's timing-sensitive
# tests under several workers: two intra-op threads.
torch.set_num_threads(2)

NDEV = 8
BLOCK = 256
JOIN_Q = (
    "l = px.DataFrame(table='dims')\n"
    "r = px.DataFrame(table='facts')\n"
    "j = l.merge(r, how='{how}', left_on=['svc'], right_on=['service'], suffixes=['', '_r'])\n"
    "px.display(j, 'joined')\n"
)
TWO_COL_Q = (
    "l = px.DataFrame(table='dims2')\n"
    "r = px.DataFrame(table='facts2')\n"
    "j = l.merge(r, how='{how}', left_on=['svc', 'code'], right_on=['service', 'code2'],"
    " suffixes=['', '_r'])\n"
    "px.display(j, 'joined')\n"
)


@pytest.fixture(autouse=True)
def _join_flags():
    for f in (flags, ref_flags):
        f.set("device_join_min_rows", 1)
    yield
    for f in (flags, ref_flags):
        f.reset("device_join_min_rows")
    flags.reset("mesh_distributed_join")


def _fill(carnot, pkg: str, nl=600, nr=900, seed=3, kl=24, kr=30) -> None:
    """tests/test_mesh_fold.py's dims and facts: ``kl`` left keys, the right
    side's keys from kl // 2 to kr, so every join type has unmatched rows
    on both sides."""
    dt, rel = (RefDT, RefRelation) if pkg == "ref" else (DataType, Relation)
    rng = np.random.default_rng(seed)
    carnot.table_store.create_table("dims", rel.of(
        ("svc", dt.STRING), ("owner", dt.FLOAT64), ("rank", dt.INT64))).write_pydict({
            "svc": np.array([f"s{i}" for i in rng.integers(0, kl, nl)], dtype=object),
            "owner": rng.standard_normal(nl),
            "rank": rng.integers(-5, 2_000_000, nl),
        })
    carnot.table_store.create_table("facts", rel.of(
        ("service", dt.STRING), ("lat", dt.FLOAT64), ("code", dt.INT64))).write_pydict({
            "service": np.array([f"s{i}" for i in rng.integers(kl // 2, kr, nr)], dtype=object),
            "lat": rng.standard_normal(nr),
            "code": rng.integers(0, 7, nr),
        })


def _fill_two_col(carnot, pkg: str, nl=500, nr=800, seed=11) -> None:
    dt, rel = (RefDT, RefRelation) if pkg == "ref" else (DataType, Relation)
    rng = np.random.default_rng(seed)
    carnot.table_store.create_table("dims2", rel.of(
        ("svc", dt.STRING), ("code", dt.INT64), ("owner", dt.FLOAT64))).write_pydict({
            "svc": np.array([f"s{i}" for i in rng.integers(0, 9, nl)], dtype=object),
            "code": rng.integers(0, 5, nl),
            "owner": rng.standard_normal(nl),
        })
    carnot.table_store.create_table("facts2", rel.of(
        ("service", dt.STRING), ("code2", dt.INT64), ("lat", dt.FLOAT64))).write_pydict({
            "service": np.array([f"s{i}" for i in rng.integers(4, 14, nr)], dtype=object),
            "code2": rng.integers(2, 8, nr),
            "lat": rng.standard_normal(nr),
        })


def _port(spec, query, fill=_fill, devices=None, runs=1, **kw):
    """(the port's tables of ``runs`` queries, its lanes, the executor)."""
    cfg = MeshConfig.parse(spec, NDEV)
    ex = DeviceExecutor(block_rows=BLOCK, mesh_config=cfg, devices=devices or ["cpu"] * NDEV)
    c = Carnot(device_executor=ex)
    fill(c, "port", **kw)
    segment.reduce_lanes(reset=True)
    outs = [c.execute_query(query).table("joined") for _ in range(runs)]
    return outs, segment.reduce_lanes(reset=True), ex


def _ref(spec, query, fill=_fill, **kw):
    """(the reference's table: on a mesh of ``spec``, or on its host engine
    when ``spec`` is None, and its lanes)."""
    ex = None if spec is None else MeshExecutor(
        block_rows=BLOCK, mesh_config=RefMeshConfig.parse(spec, NDEV))
    c = RefCarnot(device_executor=ex)
    fill(c, "ref", **kw)
    ref_segment.reduce_lanes(reset=True)
    out = c.execute_query(query).table("joined")
    if ex is not None:
        assert not ex.fallback_errors, ex.fallback_errors
    return out, ref_segment.reduce_lanes(reset=True)


# ------------------------------------------------------------- the join lane
@pytest.mark.parametrize("spec", ["hosts:2,d:4", "hosts:4,d:2"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_partitioned_join_matches_reference(how, spec):
    q = JOIN_Q.format(how=how)
    host, _ = _ref(None, q)
    want, ref_lanes = _ref(spec, q)
    assert ref_lanes.get("join_partitioned"), ref_lanes
    assert want == host
    got, lanes, _ = _port(spec, q, runs=2)  # cold, then from the staged cache
    assert lanes == {"join_partitioned": 2}, lanes
    for g in got:
        assert g == want


def test_partitioned_join_empty_shards():
    """3 left keys over 4 hosts: some host's range holds no key at all; its
    region is only padding, and its sort-merge emits nothing."""
    q = JOIN_Q.format(how="outer")
    kw = dict(nl=90, nr=140, kl=3, kr=5)
    want, ref_lanes = _ref("hosts:4,d:2", q, **kw)
    assert ref_lanes.get("join_partitioned")
    assert want == _ref(None, q, **kw)[0]
    got, lanes, ex = _port("hosts:4,d:2", q, **kw)
    assert lanes == {"join_partitioned": 1}
    assert got[0] == want
    rows = [int(st.mask.sum()) for st in ex._staged_cache.values()]
    per_host = [
        [int(st.mask[2 * h : 2 * h + 2].sum()) for h in range(4)]
        for st in ex._staged_cache.values()
    ]
    assert sum(rows) == 90 + 140
    assert any(0 in p for p in per_host), per_host


def test_partitioned_join_over_distinct_devices():
    """"cpu" and "cpu:0" are two devices to torch: each host's inner shards
    are ShardedBlocks parts, concatenated onto the host's first device."""
    q = JOIN_Q.format(how="outer")
    want = _port("hosts:2,d:4", q)[0][0]
    got, lanes, ex = _port("hosts:2,d:4", q, devices=["cpu", "cpu:0"] * 4)
    assert lanes == {"join_partitioned": 1}
    assert all(isinstance(st.mask, staging.ShardedBlocks) for st in ex._staged_cache.values())
    assert got[0] == want


def test_flag_off_takes_the_replicated_lane():
    flags.set("mesh_distributed_join", False)
    q = JOIN_Q.format(how="inner")
    got, lanes, _ = _port("hosts:2,d:4", q)
    assert lanes == {"join_sort_merge": 1}, lanes
    assert got[0] == _ref(None, q)[0]


def test_partitioned_equals_replicated_and_flat():
    q = JOIN_Q.format(how="outer")
    part = _port("hosts:2,d:4", q)[0][0]
    flags.set("mesh_distributed_join", False)
    assert _port("hosts:2,d:4", q)[0][0] == part
    assert _port("d:8", q)[0][0] == part


def test_geometry_moving_mid_join_keeps_the_planned_one():
    """Another query may move the shared executor to another rung while a
    partitioned join stages: the join stays on the mesh it planned for."""
    q = JOIN_Q.format(how="outer")
    want = _ref("hosts:2,d:4", q)[0]
    cfg = MeshConfig.parse("hosts:2,d:4", NDEV)
    ex = DeviceExecutor(block_rows=BLOCK, mesh_config=cfg, devices=["cpu"] * NDEV)
    c = Carnot(device_executor=ex)
    _fill(c, "port")
    stage_side = ex._stage_partitioned_side

    def stage_then_degrade(*args, **kw):
        out = stage_side(*args, **kw)
        ex._activate_geometry(MeshConfig.flat(NDEV))
        return out

    ex._stage_partitioned_side = stage_then_degrade
    segment.reduce_lanes(reset=True)
    got = c.execute_query(q).table("joined")
    assert segment.reduce_lanes(reset=True) == {"join_partitioned": 1}
    assert ex.mesh_config.signature() == "d:8"
    assert got == want


@pytest.mark.parametrize("how", ["inner", "left"])
def test_two_column_key_matches_reference(how):
    q = TWO_COL_Q.format(how=how)
    want, ref_lanes = _ref("hosts:2,d:4", q, fill=_fill_two_col)
    assert ref_lanes.get("join_partitioned")
    assert want == _ref(None, q, fill=_fill_two_col)[0]
    got, lanes, _ = _port("hosts:2,d:4", q, fill=_fill_two_col)
    assert lanes == {"join_partitioned": 1}
    assert got[0] == want


# ---------------------------------------------------------- staging, rules
@pytest.mark.parametrize("spec", ["hosts:2,d:4", "hosts:4,d:2"])
def test_stage_partitioned_matches_reference(spec):
    rng = np.random.default_rng(5)
    H = int(spec.split(",")[0].split(":")[1])
    rows = np.array([1500, 0, 2700, 64][:H], np.int64)
    n = int(rows.sum())
    cols = {
        "a": rng.integers(1000, 1200, n),  # narrowed to uint8
        "b": rng.standard_normal(n),
        "c": rng.integers(-(2**62), 2**62, n),  # raw int64
    }
    gids = rng.integers(0, 300, n).astype(np.int32)
    ref = ref_staging.stage_partitioned(
        RefMeshConfig.parse(spec, NDEV).build(), {k: v.copy() for k, v in cols.items()},
        gids, rows, 300, block_rows=BLOCK)
    mesh = MeshConfig.parse(spec, NDEV).build(["cpu"] * NDEV)
    got = staging.stage_partitioned(mesh, {k: v.copy() for k, v in cols.items()}, gids, rows,
                                     300, block_rows=BLOCK)
    assert got.narrow_offsets == ref.narrow_offsets
    assert got.num_rows == n and got.block_rows == ref.block_rows
    for name in cols:
        assert np.array_equal(got.blocks[name].numpy(), np.asarray(ref.blocks[name])), name
    assert np.array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert np.array_equal(got.gids.numpy(), np.asarray(ref.gids))


def test_partitioned_staging_puts_shard_i_on_device_i():
    """What the reference's partition rules say of a staging's data lanes:
    blocks, mask and gids shard i live on the mesh's device i."""
    rng = np.random.default_rng(9)
    n = 5000
    cols = {"v": rng.standard_normal(n), "k": rng.integers(0, 9, n)}
    gids = rng.integers(0, 40, n).astype(np.int32)
    mesh = MeshConfig.parse("hosts:2,d:2", 4).build(["cpu", "cpu:0"] * 2)
    rows = np.array([3000, 2000], dtype=np.int64)  # per host, ragged
    got = staging.stage_partitioned(mesh, cols, gids, rows, 40, block_rows=BLOCK)
    assert got.devices == mesh.devices
    # Two distinct devices: each lane is one tensor a shard, not one [D, ...].
    for lane in [*got.blocks.values(), got.mask, got.gids]:
        assert isinstance(lane, staging.ShardedBlocks) and len(lane.parts) == 4
    valid = [0, 0]
    for s in range(4):
        assert got.shard_device(s) == mesh.devices[s]
        valid[s // 2] += int(got.shard(s).mask.sum())
    assert valid == rows.tolist()
