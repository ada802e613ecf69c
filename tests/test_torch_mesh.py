"""The sharded fold on a mesh: the port's DeviceExecutor over 8 logical shards
of the CPU against the reference's MeshExecutor on its 8 virtual CPU devices
(tests/conftest.py), on the same numpy tables.

Held exactly: MeshConfig's parse, signature, flat, degrade and ladder; the
shard-major staging (each shard's blocks, mask and gids); the merge of
integer, HLL and count-min states; config 10's counts, min/max, HLL and
count-min at every mesh width; the reservoir's JSON; the join-aggregate, scan
and INNER/LEFT join rows in order. f64 sums within PERF.md's bound, 1e-12 of
the group's sum of |v| (ROADMAP Fault-17: the port's in-shard f64 sums add in
another order). The t-digest under Fault-4's contract. Where the reference's
CPU collectives differ from the port's merge (pmax/pmin over NaN and +-0,
subnormals flushed), the test pins both rules (Fault-17).
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from pixie_tpu.distributed.mesh import MeshConfig as RefMeshConfig
from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.parallel import staging as ref_staging
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.distributed import MeshConfig
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import merge
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.parallel import staging
from pixie_tpu_torch.serving.residency import staged_nbytes
from pixie_tpu_torch.serving.shared_scan import SharedScanCoordinator
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.registry import default_registry
from pixie_tpu_torch.utils import flags

# The CPU tests share their host with the reference's timing-sensitive
# tests under several workers: two intra-op threads.
torch.set_num_threads(2)

NDEV = 8
BLOCK = 1 << 13
ROWS = 100_000
AGG_QUERY = (  # tools/microbench_mesh.py's AGG_QUERY (bench.py config 10)
    "df = px.DataFrame(table='mesh_bench')\n"
    "g = df.groupby('service').agg("
    "n=('lat', px.count), s=('lat', px.sum),"
    " mn=('lat', px.min), mx=('lat', px.max),"
    " u=('service', px.approx_count_distinct),"
    " cm=('status', px.count_min))\n"
    "px.display(g, 'out')\n"
)
SUM_BOUND = 1e-12  # PERF.md's bound of a port f64 sum: 1e-12 * sum |v|


def cpu_shards(spec: str = f"d:{NDEV}", n: int = NDEV, block_rows: int = BLOCK):
    return DeviceExecutor(block_rows=block_rows, mesh_config=MeshConfig.parse(spec, n),
                          devices=["cpu"] * n)


def ref_mesh(spec: str = f"d:{NDEV}", block_rows: int = BLOCK):
    return MeshExecutor(block_rows=block_rows, mesh_config=RefMeshConfig.parse(spec, NDEV))


# ---------------------------------------------------------------- geometry
SPECS = ["", "d:8", "hosts:1,d:8", "hosts:2,d:4", "hosts:4,d:2", "hosts:8,d:1",
         "hosts:2,d:-1", "hosts:-1,d:2", "a:2,b:2,c:2", "hosts:4,r:1,d:2"]


def _geometry(cfg) -> tuple:
    ladder = [None if r is None else r.signature() for r in cfg.ladder()]
    deg = cfg.degrade()
    return (cfg.axes, cfg.names, cfg.shape, cfg.total_devices, cfg.signature(),
            None if deg is None else deg.signature(), ladder)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_config_matches_reference(spec):
    assert _geometry(MeshConfig.parse(spec, NDEV)) == _geometry(RefMeshConfig.parse(spec, NDEV))
    assert MeshConfig.flat(NDEV).signature() == RefMeshConfig.flat(NDEV).signature()
    for lost in (1, 2, 3):
        a, b = MeshConfig.parse(spec, NDEV).degrade(lost), RefMeshConfig.parse(spec, NDEV).degrade(lost)
        assert (a is None and b is None) or a.signature() == b.signature()


@pytest.mark.parametrize("spec", ["hosts:3,d:-1", "d:4", "x", "a:-1,b:-1", "d:0", "a:2,a:4"])
def test_mesh_config_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        RefMeshConfig.parse(spec, NDEV)
    with pytest.raises(ValueError):
        MeshConfig.parse(spec, NDEV)


def test_a_geometry_never_shrinks_to_its_devices():
    cfg = MeshConfig.parse("hosts:2,d:2", 4)
    with pytest.raises(ValueError, match="wants 4 devices, have 3"):
        cfg.build(["cpu"] * 3)
    with pytest.raises(ValueError):
        DeviceExecutor(mesh_config=cfg, devices=["cpu"] * 5)
    with pytest.raises(ValueError):  # no device list: the named device alone
        DeviceExecutor(mesh_config=cfg, device="cpu")
    ex = DeviceExecutor(device="cpu")
    assert ex.mesh.size == 1 and ex.mesh_config.signature() == "d:1"
    ex = cpu_shards("hosts:2,d:2", 4)
    assert ex.mesh.devices == (torch.device("cpu"),) * 4 and ex.device == torch.device("cpu")


def test_mesh_axes_flag_sets_the_geometry():
    flags.set("mesh_axes", "hosts:2,d:-1")
    try:
        ex = DeviceExecutor(devices=["cpu"] * 4)
        assert ex.mesh_config.signature() == "hosts:2,d:2"
        with pytest.raises(ValueError):
            DeviceExecutor(device="cpu")  # one device: hosts:2 cannot fit
    finally:
        flags.reset("mesh_axes")


# ---------------------------------------------------------------- staging
def _stage_cols(n: int, seed: int = 3) -> tuple:
    rng = np.random.default_rng(seed)
    cols = {
        "lat": rng.standard_normal(n),
        "status": rng.integers(200, 205, n),  # narrowed to uint8
        "big": rng.integers(-(2**62), 2**62, n),  # raw int64
        "sorted": np.repeat(np.arange(n // 1000 + 1), 1000)[:n],  # RLE
        "f": rng.exponential(3.0, n),  # staged as f32
    }
    gids = rng.integers(0, 300, n).astype(np.int32)
    return cols, gids


@pytest.mark.parametrize("d", [2, NDEV])
def test_staging_shards_match_reference(d):
    n = 50_000
    cols, gids = _stage_cols(n)
    ref = ref_staging.stage_columns(
        RefMeshConfig.flat(d).build(jax.devices()[:d]), {k: v.copy() for k, v in cols.items()},
        n, gids=gids, num_groups=300, block_rows=BLOCK, f32_cols={"f"},
    )
    got = staging.stage_columns(
        {k: v.copy() for k, v in cols.items()}, n, ["cpu"] * d, block_rows=BLOCK,
        f32_cols={"f"}, gids=gids, num_groups=300,
    )
    assert got.num_shards == d and got.num_blocks == np.asarray(ref.mask).shape[1]
    assert got.narrow_offsets == ref.narrow_offsets
    for s in range(d):
        sv = got.shard(s)
        for name in ref.blocks:
            want = np.asarray(ref.blocks[name])[s : s + 1]
            assert np.array_equal(sv.blocks[name].numpy().view(np.uint8), want.view(np.uint8)), name
        assert np.array_equal(sv.mask.numpy(), np.asarray(ref.mask)[s : s + 1])
        assert np.array_equal(sv.gids.numpy(), np.asarray(ref.gids)[s : s + 1])


def test_stream_windows_match_reference_packs():
    """The streamed staging over 8 shards: every window's [8, nblk, b] slice
    (decoded from the codec per shard) equals the reference's pack of that
    window (its codec off: the raw pack), and the mask marks each window's
    rows."""
    n = 70_000
    cols, gids = _stage_cols(n, seed=4)
    mesh = RefMeshConfig.flat(NDEV).build()
    ref_flags.set("staging_codec", False)
    try:
        rplan = ref_staging.plan_stream(mesh, cols, n, 1 << 15, block_rows=BLOCK,
                                        num_groups=300, has_gids=True, gids=gids)
        packs = [ref_staging.pack_stream_window(rplan, cols, gids, w)
                 for w in range(rplan.n_windows)]
    finally:
        ref_flags.reset("staging_codec")
    plan = staging.plan_stream(cols, n, 1 << 15, block_rows=BLOCK, num_groups=300,
                               has_gids=True, gids=gids, d=NDEV)
    assert (plan.n_windows, plan.nblk, plan.b) == (rplan.n_windows, rplan.nblk, rplan.b)
    assert plan.codecs, "the sorted column ships encoded"
    stager = staging.WindowStager(plan, ["cpu"] * NDEV)
    for w in range(plan.n_windows):
        stager.put(stager.pack(cols, gids, w))
    st = stager.staged
    for w, (rows, packed, pgids, _) in enumerate(packs):
        lo, hi = w * plan.nblk, (w + 1) * plan.nblk
        for name, arr in packed.items():
            assert np.array_equal(st.blocks[name][:, lo:hi].numpy(), arr), (w, name)
        assert np.array_equal(st.gids[:, lo:hi].numpy(), pgids)
        flat = (np.arange(NDEV * plan.nblk * plan.b) < rows).reshape(NDEV, plan.nblk, plan.b)
        assert np.array_equal(st.mask[:, lo:hi].numpy(), flat)


def test_lanes_over_distinct_devices():
    """torch names the CPU two ways ("cpu" and "cpu:0"); a mesh over both
    treats them as two devices, so the lanes of distinct devices
    (``ShardedBlocks``, one tensor a shard) and the per-shard landing, fold
    and merge run here as on several cards: config 10, a head scan and an
    INNER join equal the logical shards of one device."""
    data = _mesh_table(n=50_000, seed=17)
    mixed = ["cpu", "cpu:0"] * 4
    ex = DeviceExecutor(block_rows=BLOCK, mesh_config=MeshConfig.parse(f"d:{NDEV}", NDEV),
                        devices=mixed)
    got = _run_port_mesh(ex, data)
    lanes = [v for st in ex._staged_cache.values() for v in [st.mask, *st.blocks.values()]]
    assert lanes and all(isinstance(v, staging.ShardedBlocks) for v in lanes)
    want = _run_port_mesh(cpu_shards(), data, queries=1)[0]
    for g in got:
        assert g == want
    for query in (HEAD.format(n=300), JOIN.format(how="inner")):
        outs = []
        for devices in (mixed, ["cpu"] * NDEV):
            c = Carnot(device_executor=DeviceExecutor(
                block_rows=BLOCK, mesh_config=MeshConfig.flat(NDEV), devices=devices))
            _fill_join(c, "port")
            flags.set("device_join_min_rows", 0)
            try:
                outs.append(c.execute_query(query).table("out"))
            finally:
                flags.reset("device_join_min_rows")
        assert outs[0] == outs[1]


def test_residency_counts_every_shard():
    parts = [torch.zeros((1, 4, 8), dtype=torch.int64) for _ in range(3)]
    lane = staging.ShardedBlocks(parts)
    assert lane.shape == (3, 4, 8) and lane[:, 1:3].shape == (3, 2, 8)
    staged = staging.StagedColumns(blocks={"a": lane}, mask=staging.ShardedBlocks(
        [torch.zeros((1, 4, 8), dtype=torch.bool)] * 3), num_rows=0, block_rows=8)
    assert staged_nbytes(staged) == 3 * 4 * 8 * 8 + 3 * 4 * 8


def _ring_table(c, n: int = 30_000) -> None:
    rng = np.random.default_rng(4)
    t = c.table_store.create_table("t", Relation.of(
        ("svc", DataType.STRING), ("v", DataType.INT64), ("x", DataType.FLOAT64)))
    for off in range(0, n, 3000):
        m = min(3000, n - off)
        t.write_pydict({"svc": rng.choice(["a", "b", "c"], m).astype(object),
                        "v": rng.integers(0, 50, m), "x": rng.standard_normal(m)})


RING_QUERY = (
    "df = px.DataFrame(table='t')\n"
    "g = df.groupby('svc').agg(n=('v', px.count), s=('x', px.sum), hi=('v', px.max))\n"
    "px.display(g, 'out')\n"
)


def test_ring_on_a_mesh_serves():
    """A resident ring on d:4 stages shard-major windows and serves them:
    over 4 logical shards of the CPU (one [4, nblk, b] tensor a column) and
    over devices torch counts as distinct ("cpu", "cpu:0": a ShardedBlocks
    a column), each equal to the same geometry without the ring."""
    outs = []
    for devices in (["cpu"] * 4, ["cpu", "cpu:0"] * 2):
        flags.set("resident_ingest", True)
        flags.set("resident_window_rows", 8192)
        flags.set("streaming_window_rows", 8192)
        try:
            ex = DeviceExecutor(block_rows=1024, mesh_config=MeshConfig.parse("d:4", 4),
                                devices=devices)
            c = Carnot(device_executor=ex)
            _ring_table(c)
            ring = ex._resident.ring_for("t")
            assert ring.d == 4 and ring.snapshot()["windows"] == 3 and ring.snapshot()["valid"]
            lanes = [b for w in ring.windows.values() for b in w.blocks.values()]
            sharded = len(set(devices)) > 1
            assert all(isinstance(b, staging.ShardedBlocks) == sharded for b in lanes)
            assert all(b.shape == (4, ring.nblk, ring.b) for b in lanes)
            # Every shard's bytes are pinned.
            assert ex._staged_cache.snapshot()["resident_bytes"] == 3 * 8192 * (4 + 8 + 8)
            staging.reset_cold_profile()
            got = c.execute_query(RING_QUERY).table("out")
            assert staging.reset_cold_profile().get("stage_resident_hits") == 3.0
            flags.set("resident_ingest", False)
            ex.clear_caches()
            assert c.execute_query(RING_QUERY).table("out") == got
            outs.append(got)
        finally:
            for k in ("resident_ingest", "resident_window_rows", "streaming_window_rows"):
                flags.reset(k)
    assert outs[0] == outs[1]
    assert sum(outs[0]["n"]) == 30_000


def test_default_geometry_spans_every_card(monkeypatch):
    """With ``mesh_axes`` empty and no device named, the executor's mesh is
    flat over every card, as the reference's spans every local device; a
    named device stays one device, and the flag's geometry spans the same
    list."""
    from pixie_tpu_torch.distributed import mesh as mesh_mod

    cards = ["cpu", "cpu:0", "cpu", "cpu:0"]  # four devices to the mesh

    def local_devices(device=None):
        if device is not None:
            return [mesh_mod.indexed_device(device)]
        return [mesh_mod.indexed_device(d) for d in cards]

    monkeypatch.setattr(mesh_mod, "local_devices", local_devices)
    m, cfg = mesh_mod.resolve_mesh()
    assert cfg.signature() == "d:4" and m.devices == tuple(torch.device(d) for d in cards)
    assert cfg.signature() == RefMeshConfig.parse("", 4).signature()
    ex = DeviceExecutor()
    assert ex.mesh.size == 4 and ex.mesh_config.signature() == "d:4"
    assert ex.device == torch.device("cpu")
    m, cfg = mesh_mod.resolve_mesh(device="cpu")
    assert cfg.signature() == "d:1" and m.devices == (torch.device("cpu"),)
    assert DeviceExecutor(device="cpu").mesh.size == 1
    flags.set("mesh_axes", "hosts:2,d:-1")
    try:
        assert mesh_mod.resolve_mesh()[1].signature() == "hosts:2,d:2"
        with pytest.raises(ValueError):
            mesh_mod.resolve_mesh(device="cpu")  # one device: hosts:2 cannot fit
    finally:
        flags.reset("mesh_axes")
    cards[:] = ["cpu"]
    assert mesh_mod.resolve_mesh()[1].signature() == "d:1"


# ---------------------------------------------------------------- the merge
def _uda_specs(registry, dt) -> list:
    F, I, S = dt.FLOAT64, dt.INT64, dt.STRING
    names = [("sum_i", "sum", I), ("sum_f", "sum", F), ("mn", "min", F), ("mx", "max", F),
             ("mxi", "max", I), ("mean", "mean", F), ("u", "approx_count_distinct", I),
             ("cm", "count_min", I)]
    return [(out, None, registry.lookup_uda(name, [t])) for out, name, t in names]


SUBNORMAL_COLS = (2,)  # the f64 lanes' subnormal column


def _crafted_states(G: int = 6, D: int = NDEV) -> tuple:
    """[D] shard states of _uda_specs (the last two shards all padding: the
    identities) and presence, with int64 wrap, NaN, +-0 and subnormals."""
    rng = np.random.default_rng(9)
    shards, presence = [], []
    for s in range(D):
        empty = s >= D - 2
        f = rng.standard_normal(G) * 10
        f[0] = np.nan if s == 1 else f[0]  # shard 1's NaN
        f[1] = -0.0 if s % 2 == 0 else 0.0  # +-0 disagreeing
        f[2] = 5e-324 * (s + 1)  # subnormals
        f[3] = -0.0
        ints = rng.integers(2**62, 2**63 - 1, G)  # sums overflow
        st = [
            ints, f.copy(),
            np.where(np.arange(G) < 4, f, f + 1.0), f.copy(),
            rng.integers(-(2**63), 2**63 - 1, G),
            {"sum": f.copy(), "count": rng.integers(0, 100, G)},
            rng.integers(0, 30, (G, 2048)).astype(np.int32),
            {"cm": rng.integers(0, 1000, (G, 4, 8192)), "total": rng.integers(0, 1000, G)},
        ]
        if empty:
            st = [np.zeros(G, np.int64), np.zeros(G), np.full(G, np.inf), np.full(G, -np.inf),
                  np.full(G, -(2**63), np.int64), {"sum": np.zeros(G), "count": np.zeros(G, np.int64)},
                  np.zeros((G, 2048), np.int32),
                  {"cm": np.zeros((G, 4, 8192), np.int64), "total": np.zeros(G, np.int64)}]
        shards.append(st)
        presence.append(np.zeros(G, np.int64) if empty else rng.integers(1, 50, G))
    return shards, presence


def _ref_merge(specs, shards, presence) -> tuple:
    """The reference's _merge_states under shard_map over its 8 devices."""
    from jax.sharding import PartitionSpec as P
    from pixie_tpu.parallel.pipeline import _SM_CHECK_KW, shard_map

    ex = ref_mesh()
    axis = ex.mesh_axes
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *shards)
    pres = np.stack(presence)

    def fn(st, pr):
        st = jax.tree.map(lambda x: x[0], st)
        merged, p = ex._merge_states(specs, st, pr[0], NDEV, axis)
        return jax.tree.map(lambda x: x[None], merged), p[None]

    f = jax.jit(shard_map(fn, mesh=ex.mesh, in_specs=(P(axis), P(axis)),
                          out_specs=(P(axis), P(axis)), **_SM_CHECK_KW))
    merged, p = f(stacked, pres)
    return jax.tree.map(lambda x: np.asarray(x)[0], merged), np.asarray(p)[0]


def _fault5(vals: np.ndarray, is_min: bool) -> np.ndarray:
    """The port's rule per group, in shard order: a NaN wins (canonical),
    -0.0 below +0.0."""
    out = []
    for col in vals.T:
        acc = col[0]
        for v in col[1:]:
            if np.isnan(acc):
                break
            if np.isnan(v):
                acc = np.float64(np.nan)
                break
            if (v < acc if is_min else v > acc) or (v == acc == 0 and np.signbit(v) == is_min):
                acc = v
        out.append(acc)
    return np.asarray(out)


def _ref_rule(vals: np.ndarray, is_min: bool) -> np.ndarray:
    """The reference's pmax/pmin on its CPU mesh (probed): a NaN is skipped
    unless every shard has one; a tie of +-0 keeps the first shard's."""
    out = []
    for col in vals.T:
        acc = col[0]
        for v in col[1:]:
            if np.isnan(acc) or (v < acc if is_min else v > acc):
                acc = v
        out.append(acc)
    return np.asarray(out)


def test_merge_states_matches_reference():
    G = 6
    shards, presence = _crafted_states(G)
    ref_specs = _uda_specs(ref_registry(), RefDT)
    want, want_p = _ref_merge(ref_specs, shards, presence)
    specs = _uda_specs(default_registry(), DataType)
    to_t = lambda x: {k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict) \
        else torch.from_numpy(x)
    got, got_p = merge.merge_states(
        specs, [[to_t(x) for x in st] for st in shards],
        [torch.from_numpy(p) for p in presence], torch.device("cpu"),
    )
    got = [{k: v.numpy() for k, v in g.items()} if isinstance(g, dict) else g.numpy() for g in got]
    assert np.array_equal(got_p, want_p)
    for i in (0, 4, 6):  # int64 sums wrap, int64 max, HLL registers
        assert np.array_equal(got[i], want[i]), specs[i][0]
    for k in ("cm", "total"):
        assert np.array_equal(got[7][k], want[7][k])
    assert np.array_equal(got[5]["count"], want[5]["count"])
    # f64 sums: the reference's psum adds in shard order, as the port does,
    # but flushes subnormals (Fault-13).
    normal = [j for j in range(G) if j not in SUBNORMAL_COLS]
    for a, b in ((got[1], want[1]), (got[5]["sum"], want[5]["sum"])):
        assert np.array_equal(a[normal].view(np.int64), b[normal].view(np.int64))
        assert b[2] == 0.0 and a[2] == np.sum([5e-324 * (s + 1) for s in range(NDEV - 2)])
    # f64 min/max: the port follows Fault-5, the reference skips a NaN and
    # keeps shard 0's zero; both pinned (Fault-17), equal on the other groups.
    for i, is_min in ((2, True), (3, False)):
        vals = np.stack([st[i] for st in shards])
        assert np.array_equal(got[i].view(np.int64), _fault5(vals, is_min).view(np.int64))
        flushed = np.where(np.abs(vals) < 2.2250738585072014e-308, np.copysign(0.0, vals), vals)
        assert np.array_equal(want[i][normal].view(np.int64),
                              _ref_rule(flushed, is_min)[normal].view(np.int64))
        same = [j for j in normal if j not in (0, 1)]
        assert np.array_equal(got[i][same].view(np.int64), want[i][same].view(np.int64))
        assert np.isnan(got[i][0]) and not np.isnan(want[i][0])


def test_pmax_pmin_rules_at_every_shard():
    """A NaN, a -0.0 among +0.0 and a +0.0 among -0.0 at each of the 8
    shards in turn: the reference's pmax/pmin follow ``_ref_rule`` (a NaN
    never wins over a number; a zero tie keeps shard 0's), the port's merge
    ``_fault5`` (NaN wins; -0.0 < +0.0) (ROADMAP Fault-17)."""
    cols = []
    for k in range(NDEV):
        c = np.arange(NDEV, dtype=np.float64)
        c[k] = np.nan
        cols.append(c)
    for lone, rest in ((-0.0, 0.0), (0.0, -0.0)):
        for k in range(NDEV):
            c = np.full(NDEV, rest)
            c[k] = lone
            cols.append(c)
    vals = np.stack(cols, axis=1)  # [shard, group]
    F = RefDT.FLOAT64
    ref_specs = [(o, None, ref_registry().lookup_uda(n, [F])) for o, n in (("mn", "min"), ("mx", "max"))]
    specs = [(o, None, default_registry().lookup_uda(n, [DataType.FLOAT64]))
             for o, n in (("mn", "min"), ("mx", "max"))]
    shards = [[vals[s].copy(), vals[s].copy()] for s in range(NDEV)]
    presence = [np.ones(vals.shape[1], np.int64)] * NDEV
    want, _ = _ref_merge(ref_specs, shards, presence)
    got, _ = merge.merge_states(specs, [[torch.from_numpy(x) for x in st] for st in shards],
                                [torch.from_numpy(p) for p in presence])
    for i, is_min in ((0, True), (1, False)):
        assert np.array_equal(want[i].view(np.int64), _ref_rule(vals, is_min).view(np.int64))
        assert np.array_equal(got[i].numpy().view(np.int64), _fault5(vals, is_min).view(np.int64))


@pytest.mark.parametrize("kind", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.float64])
def test_merge_stack_plain_folds_in_shard_order(kind, dtype):
    if kind == "sum" and dtype == torch.int32:
        return
    rng = np.random.default_rng(2)
    stack = torch.from_numpy(
        rng.standard_normal((5, 64)) * 1e300 if dtype == torch.float64
        else rng.integers(-(2**31), 2**31 - 1, (5, 64)).astype(np.int64 if dtype == torch.int64
                                                                 else np.int32))
    got = merge.merge_stack_plain(stack, kind)
    acc = stack[0].clone()
    for d in range(1, 5):
        if kind == "sum":
            acc = acc + stack[d]
        else:
            acc = torch.minimum(acc, stack[d]) if kind == "min" else torch.maximum(acc, stack[d])
    assert torch.equal(got, acc)
    assert torch.equal(merge.merge_stack(stack, kind), got)  # the CPU takes the plain version


# ---------------------------------------------------------------- queries
def _mesh_table(n: int = ROWS, seed: int = 21) -> dict:
    rng = np.random.default_rng(seed)
    return {"service": np.array([f"svc{i}" for i in rng.integers(0, 64, n)], dtype=object),
            "status": rng.integers(0, 7, n), "lat": rng.standard_normal(n)}


def _fill_mesh(carnot, pkg: str, data: dict) -> None:
    dt, rel = (RefDT, RefRelation) if pkg == "ref" else (DataType, Relation)
    carnot.table_store.create_table("mesh_bench", rel.of(
        ("service", dt.STRING), ("status", dt.INT64), ("lat", dt.FLOAT64))).write_pydict(
        {k: v.copy() for k, v in data.items()})


def _run_port_mesh(ex, data, query=AGG_QUERY, name="out", queries=2) -> list:
    c = Carnot(device_executor=ex)
    _fill_mesh(c, "port", data)
    return [c.execute_query(query).table(name) for _ in range(queries)]  # cold, warm


def _run_ref_mesh(data, spec=f"d:{NDEV}", query=AGG_QUERY, name="out") -> dict:
    ex = ref_mesh(spec)
    c = RefCarnot(device_executor=ex)
    _fill_mesh(c, "ref", data)
    out = c.execute_query(query).table(name)
    assert ex.last_fold_ms is not None and not ex.fallback_errors
    return out


def _assert_config10(got: dict, want: dict, data: dict) -> None:
    for k in ("service", "n", "mn", "mx", "u", "cm"):
        assert got[k] == want[k], k
    svc = data["service"]
    for name, s in zip(got["service"], got["s"]):
        v = data["lat"][svc == name]
        assert abs(s - math.fsum(v)) <= SUM_BOUND * np.abs(v).sum(), name


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
def test_config10_widths_match_reference(hosts):
    """bench.py config 10 at each mesh width: the port's 8 shards equal the
    reference's 8 devices, cold (the stream) and warm, and the port's d:1."""
    data = _mesh_table()
    spec = f"hosts:{hosts},d:{NDEV // hosts}"
    want = _run_ref_mesh(data, spec)
    ex = cpu_shards(spec)
    cold, warm = _run_port_mesh(ex, data)
    _assert_config10(cold, want, data)
    _assert_config10(warm, want, data)
    assert ex.merge_device_ms() > 0.0
    one = _run_port_mesh(DeviceExecutor(device="cpu", block_rows=BLOCK), data, queries=1)[0]
    _assert_config10(one, want, data)


def test_multi_pass_fold_on_the_mesh():
    """A group-state budget of 0 MB in both packages: 8 passes over the
    monolithic sharded staging, each pass merged over the shards."""
    data = _mesh_table(n=60_000, seed=19)
    for f in (flags, ref_flags):
        f.set("device_group_state_budget_mb", 0)
    try:
        want = _run_ref_mesh(data, "hosts:2,d:4")
        got = _run_port_mesh(cpu_shards("hosts:2,d:4"), data)
    finally:
        for f in (flags, ref_flags):
            f.reset("device_group_state_budget_mb")
    for g in got:
        _assert_config10(g, want, data)


def test_shards_of_padding_are_identities():
    """A table smaller than a shard: most of the 8 shards hold only padding,
    and their identity states change nothing."""
    data = _mesh_table(n=3000, seed=5)
    want = _run_ref_mesh(data)
    for ex in (cpu_shards(), cpu_shards(block_rows=256)):
        for got in _run_port_mesh(ex, data):
            _assert_config10(got, want, data)


SERVICE_STATS = (
    "df = px.DataFrame(table='mesh_bench')\n"
    "df.failure = df.status >= 4\n"
    "s = df.groupby(['service']).agg(n=('lat', px.count), err=('failure', px.mean),\n"
    "    q=('lat', px.quantiles), t=('lat', px.quantiles_tdigest), v=('lat', px.variance))\n"
    "px.display(s, 'out')\n"
)


def test_service_stats_and_tdigest_on_the_mesh():
    """service_stats' UDAs and the t-digest (a TREE merge in shard order):
    counts and histogram quantiles exact, the t-digest under Fault-4's
    contract (the reference's TREE merge in the same order)."""
    data = _mesh_table(n=60_000, seed=7)
    data["lat"] = np.abs(data["lat"]) * 3e7
    want = _run_ref_mesh(data, query=SERVICE_STATS)
    for got in _run_port_mesh(cpu_shards(), data, query=SERVICE_STATS):
        assert got["service"] == want["service"] and got["n"] == want["n"]
        np.testing.assert_allclose(got["err"], want["err"], rtol=1e-12)
        np.testing.assert_allclose(got["v"], want["v"], rtol=1e-9)
        for gq, wq in zip(got["q"], want["q"]):
            g, w = json.loads(gq), json.loads(wq)
            assert list(g) == list(w)
            for k in w:
                assert abs(g[k] - w[k]) <= 2e-2 * abs(w[k]), (k, g[k], w[k])  # Fault-1 bins
        rel = []
        for gq, wq in zip(got["t"], want["t"]):
            g, w = json.loads(gq), json.loads(wq)
            top = max(abs(v) for v in w.values())
            for k in w:
                assert abs(g[k] - w[k]) <= 1e-2 * abs(w[k]) + 1e-5 * top, (k, g[k], w[k])
                rel.append(abs(g[k] - w[k]) / max(abs(w[k]), 1e-300))
        assert (np.array(rel) <= 1e-5).mean() >= 0.75


SAMPLE = (
    "df = px.DataFrame(table='mesh_bench')\n"
    "{filter}"
    "s = df.groupby(['service']).agg(r=('lat', px.reservoir_sample),\n"
    "    st=('status', px.reservoir_sample), n=('lat', px.count))\n"
    "px.display(s, 'out')\n"
)


@pytest.mark.parametrize("filt", ["", "df = df[df.lat > 0.5]\n"])
def test_reservoir_sample_json_equals_reference_on_the_mesh(filt):
    """The reservoirs' salt counts each shard's own rows: JSON string-equal
    to the reference's 8 devices only if the shards cut the rows alike."""
    data = _mesh_table(n=40_000, seed=11)
    query = SAMPLE.format(filter=filt)
    want = _run_ref_mesh(data, query=query)
    for got in _run_port_mesh(cpu_shards(), data, query=query):
        assert got == want


def _fill_join(carnot, pkg: str, n: int = 20_000) -> None:
    dt, rel = (RefDT, RefRelation) if pkg == "ref" else (DataType, Relation)
    rng = np.random.default_rng(12)
    svcs = [f"svc-{i}" for i in range(12)]
    t = carnot.table_store.create_table("fact", rel.of(
        ("time_", dt.TIME64NS), ("service", dt.STRING), ("latency", dt.FLOAT64),
        ("bytes", dt.INT64)))
    t.write_pydict({"time_": np.arange(n, dtype=np.int64) * 10,
                    "service": np.array(svcs, dtype=object)[rng.integers(0, 12, n)],
                    "latency": rng.exponential(3e7, n), "bytes": rng.integers(0, 1 << 20, n)})
    d = carnot.table_store.create_table("owners", rel.of(("svc", dt.STRING), ("owner", dt.STRING)))
    d.write_pydict({"svc": np.array(svcs[:10] + ["ghost"], dtype=object),
                    "owner": np.array([f"team-{i % 3}" for i in range(11)], dtype=object)})


JOIN = (
    "f = px.DataFrame(table='fact')\n"
    "o = px.DataFrame(table='owners')\n"
    "j = f.merge(o, how='{how}', left_on=['service'], right_on=['svc'], suffixes=['', '_o'])\n"
    "px.display(j, 'out')\n"
)
JOIN_AGG = (
    "f = px.DataFrame(table='fact')\n"
    "o = px.DataFrame(table='owners')\n"
    "j = o.merge(f, how='inner', left_on=['svc'], right_on=['service'], suffixes=['', '_f'])\n"
    "s = j.groupby(['owner']).agg(n=('latency', px.count), s=('bytes', px.sum),\n"
    "    m=('latency', px.mean), lo=('latency', px.min), hi=('latency', px.max))\n"
    "px.display(s, 'out')\n"
)
HEAD = (
    "df = px.DataFrame(table='fact')\n"
    "df = df[df.bytes >= 900000]\n"
    "df.kb = df.bytes / 1024\n"
    "df = df[['time_', 'service', 'kb']]\n"
    "df = df.head({n})\n"
    "px.display(df, 'out')\n"
)


@pytest.fixture
def join_min_rows():
    for f in (flags, ref_flags):
        f.set("device_join_min_rows", 0)
    yield
    for f in (flags, ref_flags):
        f.reset("device_join_min_rows")


def _both_join(query: str) -> tuple:
    from pixie_tpu.ops import segment as ref_segment
    from pixie_tpu_torch.ops import segment

    ex = cpu_shards()
    c = Carnot(device_executor=ex)
    _fill_join(c, "port")
    segment.reduce_lanes(reset=True)
    got = [c.execute_query(query).table("out") for _ in range(2)]
    lanes = segment.reduce_lanes(reset=True)
    rex = ref_mesh()
    r = RefCarnot(device_executor=rex)
    _fill_join(r, "ref")
    ref_segment.reduce_lanes(reset=True)
    want = r.execute_query(query).table("out")
    assert not rex.fallback_errors
    return got, want, lanes, ref_segment.reduce_lanes(reset=True)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_standalone_join_rows_in_order_on_the_mesh(join_min_rows, how):
    got, want, lanes, ref_lanes = _both_join(JOIN.format(how=how))
    assert lanes.get("join_sort_merge") == 2 and ref_lanes.get("join_sort_merge") == 1
    for g in got:
        assert g == want


def test_join_aggregate_on_the_mesh(join_min_rows):
    got, want, lanes, _ = _both_join(JOIN_AGG)
    assert lanes.get("join_agg") == 2
    for g in got:
        assert list(g) == list(want)
        for k in ("owner", "n", "s", "lo", "hi"):
            assert g[k] == want[k], k
        np.testing.assert_allclose(g["m"], want["m"], rtol=1e-12)


@pytest.mark.parametrize("n", [7, 500, 5000])
def test_head_scan_rows_in_order_on_the_mesh(n):
    """Each shard compacts up to the limit; the shards' prefixes in device
    order give the first n rows."""
    got, want, _, _ = _both_join(HEAD.format(n=n))
    for g in got:
        assert g == want


class _Capture:
    """Stands in for the coordinator: runs each query solo and keeps what it
    offered."""

    def __init__(self):
        self.calls = []

    def run(self, key, compute, batch_key=None, terms=None, compute_batch=None):
        solo = compute()
        self.calls.append(dict(batch_key=batch_key, terms=terms, compute_batch=compute_batch,
                               solo=solo))
        return solo


def test_batched_shared_scan_on_the_mesh():
    """Three queries that differ in a threshold fold as the slots of one
    batched scan over 8 shards; each slot equals the query alone, which is
    the reference's."""
    data = _mesh_table(n=40_000, seed=13)
    q = ("df = px.DataFrame(table='mesh_bench')\ndf = df[df.lat > {t}]\n"
         "s = df.groupby(['service']).agg(n=('lat', px.count), s=('status', px.sum),"
         " mx=('lat', px.max), u=('status', px.approx_count_distinct))\npx.display(s, 'out')\n")
    queries = [q.format(t=t) for t in (-0.5, 0.0, 1.0)]
    flags.set("shared_scans", True)
    flags.set("shared_scan_predicate_batching", True)
    try:
        ex = cpu_shards()
        c = Carnot(device_executor=ex)
        _fill_mesh(c, "port", data)
        for query in queries:
            c.execute_query(query)
        cap = _Capture()
        ex._shared_scans = cap
        alone = [c.execute_query(query).table("out") for query in queries]
        ex._shared_scans = SharedScanCoordinator()
    finally:
        flags.reset("shared_scans")
        flags.reset("shared_scan_predicate_batching")
    calls = cap.calls
    assert len({c_["batch_key"] for c_ in calls}) == 1 and all(c_["terms"] for c_ in calls)
    slots = calls[0]["compute_batch"]([c_["terms"] for c_ in calls])
    for call, slot in zip(calls, slots):
        (va, pa), _ = call["solo"]
        (vb, pb), _ = slot
        assert np.array_equal(pa, pb)
        for x, y in zip(va, vb):
            assert np.array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))
    for query, got in zip(queries, alone):
        want = _run_ref_mesh(data, query=query)
        for k in ("service", "n", "s", "mx", "u"):
            assert got[k] == want[k], k
