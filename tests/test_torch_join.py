"""The fourth slice: standalone equijoins, held against the reference.

Three levels, every one exact (a join only gathers, so no tolerance):

- the join primitives: the port's plain ``merge_join_pairs``,
  ``local_sort_merge`` and ``compact_unmatched_rows`` against
  pixie_tpu.ops.segment's on the slots below the match count, over
  sentinel-padded keys with many-to-many keys, keys on one side only, a cap
  at the count, and every combination of outer sections;
- the host EquijoinNode: the port's host engine (``Carnot()``, no device
  executor) against the reference's, every join type, string keys whose
  dictionaries differ, int keys, two-column keys, several probe batches (the
  unmatched probe rows of RIGHT and OUTER interleave per batch), an empty
  build side and outer null fill;
- end to end: Carnot + DeviceExecutor(device="cpu") against Carnot +
  MeshExecutor on a one-device CPU mesh, with ``device_join_min_rows`` 0 in
  both packages, over bench.py's config 8 tables (run_config_8: svc_owners,
  16 services to 4 teams, joined INNER to join_fact) and an OUTER/LEFT/RIGHT
  join to svc_owners_partial (14 of the 16 services owned, 4 services the
  fact table never names). Both packages must take their device lanes
  (``reduce_lanes`` shows ``join_sort_merge``; the reference's
  ``fallback_errors`` stays empty). The gates route the same joins to both
  host nodes; a pre-join filter is pushed down by both packages into their
  lanes, with equal results; a join feeding a group-by takes the port's
  join-aggregate lane (tests/test_torch_join_agg.py holds that lane).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.table.column import DictColumn as RefDictColumn
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu.utils import flags as ref_flags
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels, segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.utils import flags

import torch

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

N_SERVICES = 16
SERVICES = [f"ns/svc-{i}" for i in range(N_SERVICES)]
UNOWNED = (3, 11)


def partial_owners() -> list:
    """svc_owners_partial's services: 14 of the 16, with four ghost services
    the fact table never names placed between them."""
    owned = [s for i, s in enumerate(SERVICES) if i not in UNOWNED]
    return owned[:2] + ["ghost-0"] + owned[2:6] + ["ghost-1"] + owned[6:] + ["ghost-2", "ghost-3"]


def join_query(how: str, dim: str = "svc_owners", suffix: str = "") -> str:
    """bench.py's config 8 query (bench.py:1143-1149), ``how`` and the dim
    table varied, with an optional host suffix before the display."""
    return (
        f"l = px.DataFrame(table='{dim}')\n"
        "r = px.DataFrame(table='join_fact')\n"
        f"j = l.merge(r, how='{how}', left_on=['svc'], right_on=['service'],"
        " suffixes=['', '_r'])\n"
        f"{suffix}"
        "px.display(j, 'joined')\n"
    )


# ---------------------------------------------------------------- primitives
def _keys(seed: int, nb: int, n_probe: int, K: int, pad_b: int, pad_p: int):
    """Sentinel-applied keys: many-to-many, id 1 only on the probe side, id
    K - 1 only on the build side, padded rows keyed K (build) and K + 1
    (probe) with mask False."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, K, nb).astype(np.int32)
    lk[rng.random(nb) < 0.1] = 0  # a large fanout
    lk[lk == 1] = 2
    rk = rng.integers(0, K, n_probe).astype(np.int32)
    rk[rk == K - 1] = 3
    lmask = np.arange(nb) < nb - pad_b
    rmask = np.arange(n_probe) < n_probe - pad_p
    return (np.where(lmask, lk, K).astype(np.int32), np.where(rmask, rk, K + 1).astype(np.int32),
            lmask, rmask)


# (seed, build rows, probe rows, padded build rows, padded probe rows). The
# last has fewer probe rows than build rows, as join8_left_agg does: fanouts
# of 702 to 3912, with fanout-0 rows (probe-only key 1) between them.
CASES = [(0, 256, 3001, 37, 5), (1, 64, 1, 3, 0), (2, 2000, 700, 0, 100),
         (24, 1 << 15, 12, 100, 2)]


@pytest.mark.parametrize("case", CASES)
def test_merge_join_pairs_matches_reference(case):
    seed, nb, n_probe, pad_b, pad_p = case
    K = 40
    lk, rk, _, _ = _keys(seed, nb, n_probe, K, pad_b, pad_p)
    order = np.argsort(lk, kind="stable").astype(np.int32)
    sk = lk[order]
    fan = np.searchsorted(sk, rk, "right") - np.searchsorted(sk, rk, "left")
    M = int(fan.sum())
    for cap in (M, M + 13):  # a cap exactly at the count, then above it
        want = ref_segment.merge_join_pairs(jnp.asarray(sk), jnp.asarray(order), jnp.asarray(rk), cap)
        got = segment.merge_join_pairs(
            torch.from_numpy(sk), torch.from_numpy(order), torch.from_numpy(rk), cap
        )
        wb, wp, wv, wf = (np.asarray(a) for a in want)
        gb, gp, gv, gf = (a.numpy() for a in got)
        assert np.array_equal(gv, wv) and int(gv.sum()) == M
        assert np.array_equal(gb[:M], wb[:M]) and np.array_equal(gp[:M], wp[:M])
        assert np.array_equal(gf, wf) and gf.dtype == np.int32


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("caps", [(0, 0), (64, 0), (0, 64), (4096, 2048)])
def test_local_sort_merge_matches_reference(case, caps):
    """All four section combinations: INNER, RIGHT (probe unmatched), LEFT
    (build unmatched), OUTER."""
    seed, nb, n_probe, pad_b, pad_p = case
    K = 40
    cap_r, cap_l = caps
    lk, rk, lmask, rmask = _keys(seed, nb, n_probe, K, pad_b, pad_p)
    order = np.argsort(lk, kind="stable")
    fan = np.searchsorted(lk[order], rk, "right") - np.searchsorted(lk[order], rk, "left")
    M = int(fan.sum())
    want = ref_segment.local_sort_merge(
        jnp.asarray(lk), jnp.asarray(rk), jnp.asarray(lmask), jnp.asarray(rmask), M, cap_r, cap_l
    )
    got = segment.local_sort_merge(
        torch.from_numpy(lk), torch.from_numpy(rk), torch.from_numpy(lmask),
        torch.from_numpy(rmask), M, cap_r, cap_l, K,
    )
    assert np.array_equal(got[0].numpy()[:M], np.asarray(want[0])[:M])
    assert np.array_equal(got[1].numpy()[:M], np.asarray(want[1])[:M])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[3:], want[3:]):
        assert (g is None) == (w is None)
        if g is not None:  # padding entries (n) included
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("cap", [1, 500, 5000])
def test_compact_unmatched_rows_matches_reference(frac, cap):
    rng = np.random.default_rng(int(frac * 10) + cap)
    unmatched = rng.random(3000) < frac
    want = np.asarray(ref_segment.compact_unmatched_rows(jnp.asarray(unmatched), cap))
    got = segment.compact_unmatched_rows(torch.from_numpy(unmatched), cap).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("n, count, cap", [
    (3000, 0, 64), (3000, 1, 64), (3000, 640, 640), (3000, 640, 3077), (3000, 3000, 4096),
    (1, 1, 5), (1, 0, 1), (16, 16, 16), (4097, 4097, 4100),
], ids=["none", "one", "count-at-cap", "cap-past-n", "all-cap-past-n", "n1-all", "n1-none",
        "n16-all-at-cap", "n4097-all"])
def test_compact_unmatched_rows_edges_match_reference(n, count, cap):
    """The index lane's wrapper (``segment.compact_unmatched_rows`` through
    ``scan.compact_indices``) against the reference's sentinel sort at
    counts 0, 1 and at the cap, and caps past n."""
    rng = np.random.default_rng(n + count + cap)
    unmatched = np.zeros(n, bool)
    unmatched[rng.choice(n, count, replace=False)] = True
    want = np.asarray(ref_segment.compact_unmatched_rows(jnp.asarray(unmatched), cap))
    got = segment.compact_unmatched_rows(torch.from_numpy(unmatched), cap).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_join_gather_plain_sections():
    """H15's plain version: clamped gathers, widening by the offset, and
    null sections of the column's type."""
    col = torch.tensor([5, 0, 200], dtype=torch.uint8)
    idx = torch.tensor([2, -4, 9, 1], dtype=torch.int32)
    out = segment.join_gather_plain(col, [(idx, 3), (None, 2), (idx[3:], 1)], 10, -1)
    assert out.dtype == torch.int64 and out.tolist() == [210, 15, 210, -1, -1, 10]
    flags_ = torch.tensor([True, False])
    out = segment.join_gather_plain(flags_, [(idx[:2], 2), (None, 1), (None, 0)], None, 0)
    assert out.tolist() == [False, True, False]


# ---------------------------------------------------------------- tables
REL_FACT = (("time_", "TIME64NS", "ST_TIME_NS"), ("service", "STRING", "ST_SERVICE_NAME"),
            ("latency", "FLOAT64", "ST_DURATION_NS"))


def fact_data(n: int) -> dict:
    """run_config_8's join_fact (seed 46): a service index per row, uniform
    over the 16 services, and exponential(3e7) latency."""
    rng = np.random.default_rng(46)
    return {"svc_idx": rng.integers(0, N_SERVICES, n, dtype=np.uint8),
            "latency": rng.exponential(3e7, n)}


def _fill(carnot, pkg: str, fact: dict, chunks: int = 1) -> None:
    """svc_owners, svc_owners_partial and join_fact as run_config_8 writes
    them (identity service codes in the fact table), the fact table in
    ``chunks`` writes (one probe batch each)."""
    dt, rel_of, st, dict_col = (
        (RefDT, RefRelation.of, RefST, RefDictColumn) if pkg == "ref"
        else (DataType, Relation.of, SemanticType, DictColumn)
    )
    store = carnot.table_store
    for name, svcs in (("svc_owners", SERVICES), ("svc_owners_partial", partial_owners())):
        t = store.create_table(
            name, rel_of(("svc", dt.STRING, st.ST_SERVICE_NAME), ("owner", dt.STRING))
        )
        t.write_pydict({
            "svc": np.array(svcs, dtype=object),
            "owner": np.array([f"team-{i % 4}" for i in range(len(svcs))], dtype=object),
        })
        t.compact()
        t.stop()
    t = store.create_table(
        "join_fact", rel_of(*[(c, dt[k], st[s]) for c, k, s in REL_FACT])
    )
    d = t.dictionaries["service"]
    for s in SERVICES:
        d.get_code(s)
    n = len(fact["svc_idx"])
    for part in np.array_split(np.arange(n), chunks):
        t.write_pydict({
            "time_": part.astype(np.int64) * 1000,
            "service": dict_col(fact["svc_idx"][part].astype(np.int32), d),
            "latency": fact["latency"][part],
        })
    t.stop()


@pytest.fixture
def join_flags():
    """device_join_min_rows 0 in both packages (so small tables take the
    lanes), restored afterwards with any other flag the test sets."""
    saved = []

    def set_(name, value):
        for f in (flags, ref_flags):
            saved.append((f, name, f.get(name)))
            f.set(name, value)

    set_("device_join_min_rows", 0)
    yield set_
    for f, name, value in reversed(saved):
        f.set(name, value)


BLOCK_ROWS = 4096


def run_port(fact, query, chunks=1, device_executor=True):
    segment.reduce_lanes(reset=True)
    ex = DeviceExecutor(device="cpu", block_rows=BLOCK_ROWS) if device_executor else None
    c = Carnot(device_executor=ex)
    _fill(c, "port", fact, chunks)
    return c.execute_query(query).table("joined"), segment.reduce_lanes(reset=True)


def run_ref(fact, query, chunks=1, device_executor=True):
    ref_segment.reduce_lanes(reset=True)
    ex = (MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=BLOCK_ROWS)
          if device_executor else None)
    c = RefCarnot(device_executor=ex)
    _fill(c, "ref", fact, chunks)
    rows = c.execute_query(query).table("joined")
    if ex is not None:
        assert not ex.fallback_errors, ex.fallback_errors
    return rows, ref_segment.reduce_lanes(reset=True)


# ---------------------------------------------------------------- host nodes
def _host_tables(carnot, pkg: str, n_left: int, batches: list) -> None:
    """lhs (build) and rhs (probe, one write per batch) with string keys
    whose dictionaries differ (other services, another first-seen order),
    int keys on both, and keys on one side only."""
    dt, rel_of, = (RefDT, RefRelation.of) if pkg == "ref" else (DataType, Relation.of)
    rng = np.random.default_rng(5)
    tl = carnot.table_store.create_table(
        "lhs", rel_of(("svc", dt.STRING), ("code", dt.INT64), ("flag", dt.BOOLEAN),
                      ("lat", dt.FLOAT64))
    )
    if n_left:
        tl.write_pydict({
            "svc": rng.choice([f"s{i}" for i in range(12)], n_left).astype(object),
            "code": rng.choice([1, 2, 3, 99], n_left),
            "flag": rng.random(n_left) < 0.5,
            "lat": rng.normal(100.0, 10.0, n_left),
        })
    tl.stop()
    tr = carnot.table_store.create_table(
        "rhs", rel_of(("time_", dt.TIME64NS), ("svc2", dt.STRING), ("code2", dt.INT64),
                      ("cost", dt.FLOAT64))
    )
    off = 0
    for n in batches:
        tr.write_pydict({
            "time_": np.arange(off, off + n, dtype=np.int64),
            "svc2": rng.choice([f"s{i}" for i in range(20, 6, -1)], n).astype(object),
            "code2": rng.choice([2, 3, 4, 77], n),
            "cost": rng.exponential(5.0, n),
        })
        off += n
    tr.stop()


def _host_query(how: str, on: tuple) -> str:
    lo = ", ".join(f"'{k}'" for k in on[0])
    ro = ", ".join(f"'{k}'" for k in on[1])
    return (
        "l = px.DataFrame(table='lhs')\n"
        "r = px.DataFrame(table='rhs')\n"
        f"j = l.merge(r, how='{how}', left_on=[{lo}], right_on=[{ro}], suffixes=['', '_r'])\n"
        "px.display(j, 'joined')\n"
    )


KEYS = {
    "string": (("svc",), ("svc2",)),
    "int": (("code",), ("code2",)),
    "two_columns": (("svc", "code"), ("svc2", "code2")),
}


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_host_equijoin_matches_reference(how, keys):
    """Both host engines, three probe batches: every column and row order
    equal, null rows of the outer sections included."""
    q = _host_query(how, KEYS[keys])
    rows = []
    for pkg, carnot in (("port", Carnot()), ("ref", RefCarnot())):
        _host_tables(carnot, pkg, 300, [200, 150, 250])
        rows.append(carnot.execute_query(q).table("joined"))
    got, want = rows
    assert got == want and len(got["cost"]) > 0
    if how in ("left", "outer"):
        assert 0.0 in got["cost"]  # build rows with no match, null-filled


@pytest.mark.parametrize("how", ["inner", "right", "outer"])
def test_host_equijoin_empty_build_side(how):
    q = _host_query(how, KEYS["string"])
    rows = []
    for pkg, carnot in (("port", Carnot()), ("ref", RefCarnot())):
        _host_tables(carnot, pkg, 0, [40, 60])
        rows.append(carnot.execute_query(q).table("joined"))
    got, want = rows
    assert got == want
    assert len(got.get("cost", [])) == (0 if how == "inner" else 100)
    if how != "inner":
        assert set(got["svc"]) == {""} and set(got["lat"]) == {0.0}


# ---------------------------------------------------------------- end to end
@pytest.mark.parametrize("how,dim", [
    ("inner", "svc_owners"),  # config 8 verbatim
    ("inner", "svc_owners_partial"),
    ("left", "svc_owners_partial"),
    ("right", "svc_owners_partial"),
    ("outer", "svc_owners_partial"),
])
def test_device_join_matches_reference(join_flags, how, dim):
    """Both device lanes: every column and row order equal (both emit the
    matches probe-row-major, then the unmatched probe rows, then the
    unmatched build rows)."""
    fact = fact_data(20_000)
    q = join_query(how, dim)
    got, lanes = run_port(fact, q)
    want, ref_lanes = run_ref(fact, q)
    assert lanes == {"join_sort_merge": 1}
    assert ref_lanes.get("join_sort_merge") == 1
    assert got == want
    svc_idx = fact["svc_idx"]
    owned = ~np.isin(svc_idx, UNOWNED) if dim != "svc_owners" else np.ones_like(svc_idx, bool)
    n_rows = {"inner": owned.sum(), "left": owned.sum() + 4, "right": len(svc_idx),
              "outer": len(svc_idx) + 4}[how]
    assert len(got["time_"]) == n_rows
    if how == "outer":
        m = int(owned.sum())
        assert got["time_"][:m] == (np.flatnonzero(owned) * 1000).tolist()
        assert got["time_"][m:-4] == (np.flatnonzero(~owned) * 1000).tolist()
        assert set(got["svc"][m:-4]) == {""} and set(got["owner"][m:-4]) == {""}
        assert got["svc"][-4:] == [f"ghost-{i}" for i in range(4)]
        assert got["service"][-4:] == [""] * 4 and got["latency"][-4:] == [0.0] * 4


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_device_join_matches_host_node(join_flags, how):
    """The port's lane against the port's host node over a fact table
    written in three batches: INNER and LEFT equal row for row; RIGHT and
    OUTER the same rows (the host node interleaves each batch's unmatched
    probe rows, the lane puts them after every match)."""
    fact = fact_data(9_000)
    q = join_query(how, "svc_owners_partial")
    lane, lanes = run_port(fact, q, chunks=3)
    host, host_lanes = run_port(fact, q, chunks=3, device_executor=False)
    assert lanes == {"join_sort_merge": 1} and host_lanes == {}
    if how in ("inner", "left"):
        assert lane == host
    else:
        assert lane != host
        assert sorted(zip(*lane.values())) == sorted(zip(*host.values()))


def test_config8_join_through_the_kernels_path(join_flags):
    """Config 8 on the CPU reaches every primitive of the lane: one lane run,
    no kernel launch (CPU tensors take the plain versions), and numpy's
    truths: n rows, time_ and latency equal to the fact columns in row
    order, svc == service, owner == team-{i % 4}."""
    fact = fact_data(30_000)
    kernels.reset_launches()
    got, lanes = run_port(fact, join_query("inner"))
    assert lanes == {"join_sort_merge": 1} and not any(kernels.LAUNCHES.values())
    n = len(fact["svc_idx"])
    assert np.array_equal(np.asarray(got["time_"]), np.arange(n) * 1000)
    assert np.array_equal(np.asarray(got["latency"]), fact["latency"])
    assert got["svc"] == got["service"] == [SERVICES[i] for i in fact["svc_idx"]]
    assert got["owner"] == [f"team-{i % 4}" for i in fact["svc_idx"]]


def test_row_gate_keeps_both_on_the_host(join_flags):
    join_flags("device_join_min_rows", 1 << 18)
    fact = fact_data(5_000)
    q = join_query("left", "svc_owners_partial")
    got, lanes = run_port(fact, q)
    want, ref_lanes = run_ref(fact, q)
    assert lanes == {} and "join_sort_merge" not in ref_lanes
    assert got == want


def test_device_join_flag_off_keeps_both_on_the_host(join_flags):
    join_flags("device_join", False)
    fact = fact_data(5_000)
    q = join_query("outer", "svc_owners_partial")
    got, lanes = run_port(fact, q)
    want, ref_lanes = run_ref(fact, q)
    assert lanes == {} and "join_sort_merge" not in ref_lanes
    assert got == want


@pytest.mark.parametrize("how", ["inner", "left"])
def test_prejoin_filter_runs_on_the_port_host_node(join_flags, how):
    """A pre-join predicate: both packages filter the side on the host and
    take their lanes (the pushdown; tests/test_torch_join_pushdown.py holds
    it in full), and the rows equal the reference's and the port's host
    node's."""
    fact = fact_data(8_000)
    q = (
        "l = px.DataFrame(table='svc_owners_partial')\n"
        "r = px.DataFrame(table='join_fact')\n"
        "r = r[r.latency > 30000000.0]\n"
        f"j = l.merge(r, how='{how}', left_on=['svc'], right_on=['service'],"
        " suffixes=['', '_r'])\n"
        "px.display(j, 'joined')\n"
    )
    got, lanes = run_port(fact, q)
    want, ref_lanes = run_ref(fact, q)
    assert lanes == {"join_sort_merge": 1} and ref_lanes.get("join_sort_merge") == 1
    assert got == want and len(got["time_"]) > 0
    assert got == run_port(fact, q, device_executor=False)[0]


def test_host_suffix_after_the_device_join(join_flags):
    """A map and a head after the join run on the host graph against the
    lane's batch (the splice drops both sides' ancestors)."""
    fact = fact_data(10_000)
    q = join_query(
        "inner", "svc_owners",
        suffix="j.latency_ms = j.latency / 1000000.0\nj = j.head(777)\n",
    )
    got, lanes = run_port(fact, q)
    want, ref_lanes = run_ref(fact, q)
    assert lanes == {"join_sort_merge": 1} and ref_lanes.get("join_sort_merge") == 1
    assert len(got["time_"]) == 777
    assert got["latency_ms"] == (fact["latency"][:777] / 1e6).tolist()
    assert got == want


def test_write_to_either_side_restages_both(join_flags):
    """The staged sides are keyed by the whole key space: after a write to
    the build table (a new owner), the next join re-stages and matches the
    reference on the same tables."""
    fact = fact_data(6_000)
    q = join_query("outer", "svc_owners_partial")
    ex = DeviceExecutor(device="cpu", block_rows=BLOCK_ROWS)
    c = Carnot(device_executor=ex)
    _fill(c, "port", fact)
    rc = RefCarnot(device_executor=MeshExecutor(
        mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=BLOCK_ROWS))
    _fill(rc, "ref", fact)
    assert c.execute_query(q).table("joined") == rc.execute_query(q).table("joined")
    for carnot in (c, rc):
        carnot.table_store.get_table("svc_owners_partial").write_pydict({
            "svc": np.array([SERVICES[3]], dtype=object),
            "owner": np.array(["team-new"], dtype=object),
        })
    got = c.execute_query(q).table("joined")
    assert got == rc.execute_query(q).table("joined")
    assert got["owner"].count("team-new") == int((fact["svc_idx"] == 3).sum())


def test_join_then_aggregate_matches_reference(join_flags):
    """Config 8's join feeding a per-team count. The port takes its
    join-aggregate lane; the reference, whose lane declines a count of a
    right column (Fault-8), builds the pairs and counts them on its host
    AggNode. The counts are equal and numpy's."""
    fact = fact_data(3_000)
    q = join_query(
        "inner", "svc_owners",
        suffix="j = j.groupby(['owner']).agg(n=('latency', px.count))\n",
    )
    got, lanes = run_port(fact, q)
    want, ref_lanes = run_ref(fact, q)
    assert lanes == {"join_agg": 1} and ref_lanes.get("join_sort_merge") == 1
    assert got == want
    teams = fact["svc_idx"] % 4
    assert got["owner"] == [f"team-{t}" for t in range(4)]
    assert got["n"] == [int((teams == t).sum()) for t in range(4)]


@pytest.mark.parametrize("n_fact", [600, 20_000])
@pytest.mark.parametrize("how", ["left", "right", "outer"])
def test_outer_null_strings_take_the_reference_codes(join_flags, how, n_fact):
    """A STRING column with outer-null rows: the reference decodes it and
    re-encodes the strings into a fresh dictionary, numbered in sorted order
    below 1024 rows and by first occurrence above; the port's lane gives the
    same dictionary and codes (a host AggNode after the join emits its
    groups in code order)."""
    fact = fact_data(n_fact)
    q = join_query(how, "svc_owners_partial")
    batches = {}
    for pkg, carnot in (("port", Carnot(device_executor=DeviceExecutor(
            device="cpu", block_rows=BLOCK_ROWS))), ("ref", RefCarnot(device_executor=MeshExecutor(
            mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=BLOCK_ROWS)))):
        _fill(carnot, pkg, fact)
        (batches[pkg],) = [b for b in carnot.execute_query(q).tables["joined"] if b.num_rows]
    for name in ("svc", "owner", "service"):
        got, want = batches["port"].col(name), batches["ref"].col(name)
        assert got.dictionary.values() == want.dictionary.values(), name
        assert np.array_equal(got.codes, want.codes), name


def test_left_join_then_aggregate_matches_reference(join_flags):
    """chip_smoke.py's join8_left_agg: LEFT is not the join-aggregate lane's
    shape, so both sort-merge lanes build the pairs and both host AggNodes
    aggregate them: the four teams in first-occurrence order, then the
    unowned services' rows (owner ""). Counts and maxima exact, means
    within a relative 1e-12."""
    fact = fact_data(20_000)
    q = (
        "l = px.DataFrame(table='join_fact')\n"
        "r = px.DataFrame(table='svc_owners_partial')\n"
        "j = l.merge(r, how='left', left_on=['service'], right_on=['svc'], suffixes=['', '_r'])\n"
        "j = j.groupby(['owner']).agg(n=('latency', px.count), lat_mean=('latency', px.mean),"
        " lat_max=('latency', px.max))\n"
        "px.display(j, 'joined')\n"
    )
    got, lanes = run_port(fact, q)
    want, ref_lanes = run_ref(fact, q)
    assert lanes == {"join_sort_merge": 1} and ref_lanes.get("join_sort_merge") == 1
    assert got["owner"] == want["owner"] == ["team-0", "team-1", "team-3", "team-2", ""]
    assert got["n"] == want["n"] and got["lat_max"] == want["lat_max"]
    np.testing.assert_allclose(got["lat_mean"], want["lat_mean"], rtol=1e-12, atol=0)
