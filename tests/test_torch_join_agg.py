"""The fifth slice: joins that feed an aggregation (K17), held against the
reference.

- The lane: Carnot + DeviceExecutor(device="cpu") against Carnot +
  MeshExecutor on a one-device CPU mesh, over the same numpy tables
  (pixie_tpu's test_parallel.py:680 and :781, plus multi-column keys, INT64
  sums, host-densified group keys, post-join filters on each side, left and
  right min/max and a computed argument). Both must take their
  join-aggregate lanes (the port counts ``join_agg``; the reference compiles
  a ``joinL|`` program and its ``fallback_errors`` stays empty), and both
  must equal both host engines (the port's EquijoinNode + AggNode on the
  CPU, the reference's with no device executor).
- The gates: LEFT/RIGHT/OUTER, a group from the right side, quantiles after
  a join and a STRING argument decline both lanes; the port's device join
  lane and its host AggNode then equal the reference's.
- Fault-7: a masked or unmatched left row with a non-finite value.
- H16's plain version against a loop over the rows in numpy.

Tolerances: counts, INT outputs, min/max and group order exact; f64 sums
and means within a relative 1e-9 (the bound the reference's own test holds
its lane to: the lane adds in another order than the host engines).
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
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.ops import kernels, segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.utils import flags

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

BLOCK_ROWS = 512
EPS = [f"/api/{i}" for i in range(40)]


def _tables(seed: int = 5, nl: int = 6000, nr: int = 3000) -> dict:
    """test_parallel.py:680's tables (its seed and sizes): left keys from 30
    endpoints, right keys from 30 others, 20 shared (duplicates and keys on
    one side only), plus a small int code on both sides for two-column
    keys."""
    rng = np.random.default_rng(seed)
    left = {
        "time_": np.arange(nl, dtype=np.int64) * 10,
        "svc": rng.choice(["a", "b", "c"], nl).astype(object),
        "ep": rng.choice(EPS[:30], nl).astype(object),
        "lat": rng.normal(100, 10, nl),
        "bytes": rng.integers(0, 1 << 20, nl),
        "code": rng.integers(0, 3, nl),
    }
    right = {
        "time_": np.arange(nr, dtype=np.int64) * 10,
        "endpoint": rng.choice(EPS[10:], nr).astype(object),
        "cost": rng.normal(5, 1, nr),
        "quota": rng.integers(1, 100, nr),
        "code2": rng.integers(0, 3, nr),
    }
    return {
        "reqs": ((("time_", "TIME64NS"), ("svc", "STRING"), ("ep", "STRING"),
                  ("lat", "FLOAT64"), ("bytes", "INT64"), ("code", "INT64")), left),
        "costs": ((("time_", "TIME64NS"), ("endpoint", "STRING"), ("cost", "FLOAT64"),
                   ("quota", "INT64"), ("code2", "INT64")), right),
    }


def _fill(carnot, pkg: str, tables: dict) -> None:
    dt, rel_of = (RefDT, RefRelation.of) if pkg == "ref" else (DataType, Relation.of)
    for name, (schema, data) in tables.items():
        t = carnot.table_store.create_table(name, rel_of(*[(c, dt[k]) for c, k in schema]))
        t.write_pydict({k: v.copy() for k, v in data.items()})
        t.compact()
        t.stop()


@pytest.fixture(autouse=True)
def join_flags():
    """device_join_min_rows 0 in both packages, so the declined joins of
    these small tables take both standalone join lanes."""
    saved = [(f, f.get("device_join_min_rows")) for f in (flags, ref_flags)]
    for f, _ in saved:
        f.set("device_join_min_rows", 0)
    yield
    for f, v in saved:
        f.set("device_join_min_rows", v)


def run_port(tables, query, lane=True):
    segment.reduce_lanes(reset=True)
    c = (Carnot(device_executor=DeviceExecutor(device="cpu", block_rows=BLOCK_ROWS)) if lane
         else Carnot(device="cpu"))
    _fill(c, "port", tables)
    return c.execute_query(query).table("out"), segment.reduce_lanes(reset=True)


def run_ref(tables, query, lane=True):
    """(rows, took the join-aggregate lane, took the sort-merge lane)."""
    ref_segment.reduce_lanes(reset=True)
    ex = (MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=BLOCK_ROWS)
          if lane else None)
    c = RefCarnot(device_executor=ex)
    _fill(c, "ref", tables)
    rows = c.execute_query(query).table("out")
    if ex is None:
        return rows, False, False
    assert not ex.fallback_errors, ex.fallback_errors
    took = any(k.startswith("joinL|") for k in ex._program_cache)
    return rows, took, ref_segment.reduce_lanes(reset=True).get("join_sort_merge", 0) > 0


def assert_rows_match(got: dict, want: dict, rel: float = 1e-9) -> None:
    """Columns and rows in order; ints, strings and min/max exact; floats
    within ``rel`` (0: exact)."""
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert len(g) == len(w), k
        if w and isinstance(w[0], float):
            np.testing.assert_allclose(g, w, rtol=rel, atol=0, err_msg=k)
        else:
            assert g == w, k


def _query(agg: str, groups: str = "['svc']", how: str = "inner", on=("ep", "endpoint"),
           pre: str = "r = r[r.quota > 10]\n", post: str = "") -> str:
    lo = ", ".join(f"'{k}'" for k in on[0::2])
    ro = ", ".join(f"'{k}'" for k in on[1::2])
    grouped = f"j.groupby({groups}).agg(" if groups else "j.agg("
    return (
        "l = px.DataFrame(table='reqs')\n"
        "r = px.DataFrame(table='costs')\n"
        f"{pre}"
        f"j = l.merge(r, how='{how}', left_on=[{lo}], right_on=[{ro}], suffixes=['', '_r'])\n"
        f"{post}"
        f"s = {grouped}{agg})\n"
        "px.display(s, 'out')\n"
    )


# test_parallel.py:680's six aggregates.
SIX = ("n=('time_', px.count), lat_total=('lat', px.sum), cost_total=('cost', px.sum), "
       "cost_avg=('cost', px.mean), lat_max=('lat', px.max), quota_min=('quota', px.min)")

LANE_CASES = {
    "decomposition": _query(SIX),  # test_parallel.py:680 verbatim
    "two_column_keys": _query(SIX, on=("ep", "endpoint", "code", "code2")),
    "int64_sums": _query("n=('time_', px.count), bytes_total=('bytes', px.sum), "
                         "quota_total=('quota', px.sum), bytes_avg=('bytes', px.mean)"),
    "post_join_filter_left": _query(SIX, post="j = j[j.lat > 100.0]\n"),
    "post_join_filter_right": _query(SIX, post="j = j[j.cost > 5.0]\n"),
    "left_and_right_min_max": _query(
        "n=('lat', px.count), lat_min=('lat', px.min), lat_max=('lat', px.max), "
        "bytes_min=('bytes', px.min), cost_min=('cost', px.min), cost_max=('cost', px.max), "
        "quota_max=('quota', px.max)"),
    "host_densified_groups": _query(SIX, groups="['code', 'svc']"),
    "int_group_key": _query(SIX, groups="['code']", pre=""),
    "computed_argument": _query(
        "n=('time_', px.count), x_total=('x', px.sum), x_max=('x', px.max)",
        post="j.x = j.lat * 2.0 + 1.0\n"),
}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_join_agg_lane_matches_reference(case):
    q = LANE_CASES[case]
    tables = _tables()
    got, lanes = run_port(tables, q)
    want, ref_took, _ = run_ref(tables, q)
    assert lanes == {"join_agg": 1}
    assert ref_took, "the reference's join-aggregate lane did not offload"
    assert len(got["n"]) > 0
    assert_rows_match(got, want)
    host, host_lanes = run_port(tables, q, lane=False)
    ref_host, _, _ = run_ref(tables, q, lane=False)
    assert host_lanes == {}
    assert_rows_match(host, ref_host)
    assert_rows_match(got, host)


def test_join_agg_ungrouped():
    """test_parallel.py:781: a join aggregate with no group-by is one group;
    keys k0..k9 match, 500 left rows each with 50 right rows."""
    tables = {
        "lhs": ((("time_", "TIME64NS"), ("k", "STRING"), ("v", "FLOAT64")), {
            "time_": np.arange(1000, dtype=np.int64),
            "k": np.array([f"k{i % 20}" for i in range(1000)], dtype=object),
            "v": np.ones(1000) * 2.0,
        }),
        "rhs": ((("time_", "TIME64NS"), ("k2", "STRING"), ("w", "INT64")), {
            "time_": np.arange(500, dtype=np.int64),
            "k2": np.array([f"k{i % 10}" for i in range(500)], dtype=object),
            "w": np.arange(500, dtype=np.int64),
        }),
    }
    q = (
        "l = px.DataFrame(table='lhs')\n"
        "r = px.DataFrame(table='rhs')\n"
        "j = l.merge(r, how='inner', left_on=['k'], right_on=['k2'], suffixes=['', '_r'])\n"
        "s = j.agg(n=('v', px.count), total=('v', px.sum), w_total=('w', px.sum))\n"
        "px.display(s, 'out')\n"
    )
    got, lanes = run_port(tables, q)
    want, ref_took, _ = run_ref(tables, q)
    assert lanes == {"join_agg": 1} and ref_took
    assert got["n"] == [500 * 50] and got["total"] == [2.0 * 500 * 50]
    assert got["w_total"] == [50 * sum(range(500))]
    assert_rows_match(got, want, rel=0)


GATE_CASES = {
    "left": _query(SIX, how="left", pre=""),
    "right": _query(SIX, how="right", pre=""),
    "outer": _query(SIX, how="outer", pre=""),
    "group_from_the_right": _query(SIX, groups="['endpoint']", pre=""),
    "quantiles": _query("n=('time_', px.count), q=('lat', px.quantiles)", pre=""),
    "string_argument": _query("n=('svc', px.count), lat_total=('lat', px.sum)", pre=""),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gates_decline_both_lanes(case):
    """Where the reference's match_join_agg or _try_execute_join_agg
    declines, the port's lane declines: both standalone join lanes build the
    pairs and both host AggNodes aggregate them, with equal results
    (quantiles within one log bin, the Fault-1 contract)."""
    q = GATE_CASES[case]
    tables = _tables(nl=3000, nr=1500)
    got, lanes = run_port(tables, q)
    want, ref_took, ref_merge = run_ref(tables, q)
    assert lanes == {"join_sort_merge": 1} and not ref_took and ref_merge
    if case == "quantiles":
        import json

        from pixie_tpu.ops.histogram import DEFAULT_SPEC

        assert got["svc"] == want["svc"] and got["n"] == want["n"]
        for gq, wq in zip(got.pop("q"), want.pop("q")):
            g, w = json.loads(gq), json.loads(wq)
            assert g.keys() == w.keys()
            for k in w:
                assert g[k] == w[k] or max(g[k], w[k]) / min(g[k], w[k]) <= DEFAULT_SPEC.gamma * (1 + 1e-9)
    assert_rows_match(got, want)


def test_right_side_count_takes_the_port_lane():
    """Fault-8: a count whose argument is a right column needs no right
    statistic. The reference's _run_right_stats declines it (its sort-merge
    lane and host AggNode run the query); the port's lane takes it. The
    results are equal."""
    q = _query("n=('cost', px.count), cost_total=('cost', px.sum), lat_total=('lat', px.sum)")
    tables = _tables()
    got, lanes = run_port(tables, q)
    want, ref_took, ref_merge = run_ref(tables, q)
    assert lanes == {"join_agg": 1} and not ref_took and ref_merge
    assert_rows_match(got, want)


# ---------------------------------------------------------------- Fault-7
FAULT7_TABLES = {
    "lhs": ((("time_", "TIME64NS"), ("k", "STRING"), ("v", "FLOAT64")), {
        "time_": np.arange(6, dtype=np.int64),
        "k": np.array(["a", "b", "z", "a", "b", "z"], dtype=object),
        "v": np.array([1.0, 2.0, np.inf, 3.0, 4.0, np.nan]),
    }),
    "rhs": ((("time_", "TIME64NS"), ("k2", "STRING")), {
        "time_": np.arange(3, dtype=np.int64),
        "k2": np.array(["a", "b", "b"], dtype=object),
    }),
}


@pytest.mark.parametrize("pre", ["", "l = l[l.v < 100.0]\n"])
def test_fault7_skips_masked_and_unmatched_rows(pre):
    """The probe of Fault-7: the unmatched key z carries inf and NaN (and,
    with the filter, so do rows the filter drops). The reference's lane
    multiplies them by a zero weight and gives NaN; the port's lane skips
    them and gives 16.0, as both host engines do."""
    q = (
        "l = px.DataFrame(table='lhs')\n"
        f"{pre}"
        "r = px.DataFrame(table='rhs')\n"
        "j = l.merge(r, how='inner', left_on=['k'], right_on=['k2'], suffixes=['', '_r'])\n"
        "s = j.agg(n=('v', px.count), tot=('v', px.sum))\n"
        "px.display(s, 'out')\n"
    )
    got, lanes = run_port(FAULT7_TABLES, q)
    want, ref_took, _ = run_ref(FAULT7_TABLES, q)
    assert lanes == {"join_agg": 1} and ref_took
    assert want["n"] == [6] and np.isnan(want["tot"][0])
    assert got == {"n": [6], "tot": [16.0]}
    for host in (run_port(FAULT7_TABLES, q, lane=False)[0], run_ref(FAULT7_TABLES, q, lane=False)[0]):
        assert host == got


# ---------------------------------------------------------------- H16 plain
def _fold_loop(jk, gids, mask, n_right, left_vals, right_sums, cap):
    """H16 as a loop over the rows, in numpy: (acc, eff, sum |terms| per
    cell)."""
    S_l, S_r = left_vals.shape[0], right_sums.shape[0]
    acc = np.zeros((1 + S_l + S_r, cap))
    mag = np.zeros_like(acc)
    eff = np.zeros(len(jk), dtype=bool)
    for r in range(len(jk)):
        w = n_right[jk[r]] if mask[r] and 0 <= jk[r] < len(n_right) else 0.0
        eff[r] = w > 0
        g = gids[r]
        if not eff[r] or not 0 <= g < cap:
            continue
        terms = [w] + [left_vals[i, r] * w for i in range(S_l)]
        terms += [right_sums[j, jk[r]] for j in range(S_r)]
        for c, t in enumerate(terms):
            acc[c, g] += t
            mag[c, g] += abs(t)
    return acc, eff, mag


@pytest.mark.parametrize("K", [1, 16, 4096])
@pytest.mark.parametrize("cap", [1, 16, 65536])
@pytest.mark.parametrize("S_l,S_r", [(0, 0), (2, 0), (0, 2), (2, 2)])
def test_join_agg_fold_plain_matches_loop(K, cap, S_l, S_r):
    """Weights 0-5, keys and gids with some outside their ranges, masked
    and zero-weight rows carrying +-inf and NaN: the count row and the
    effective mask exact, every sum within 1e-12 * sum |terms| of its cell."""
    rng = np.random.default_rng(K * 7 + cap + 3 * S_l + S_r)
    n = 3000
    jk = rng.integers(-1, K + 1, n).astype(np.int32)
    gids = rng.integers(-1, min(cap, 64) + 1, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    n_right = rng.integers(0, 6, K).astype(np.float64)
    left_vals = rng.normal(0, 1e3, (S_l, n))
    right_sums = rng.normal(0, 1e3, (S_r, K))
    w = np.where((jk >= 0) & (jk < K), n_right[np.clip(jk, 0, K - 1)], 0.0)
    dead = ~mask | (w == 0)
    for i in range(S_l):
        left_vals[i, dead] = rng.choice([np.inf, -np.inf, np.nan], int(dead.sum()))
    want, want_eff, mag = _fold_loop(jk, gids, mask, n_right, left_vals, right_sums, cap)
    acc = torch.zeros((1 + S_l + S_r, cap), dtype=torch.float64)
    eff = torch.empty(n, dtype=torch.bool)
    segment.join_agg_fold(
        torch.from_numpy(jk), torch.from_numpy(gids), torch.from_numpy(mask),
        torch.from_numpy(n_right), torch.from_numpy(left_vals), torch.from_numpy(right_sums),
        acc, eff,
    )
    got = acc.numpy()
    assert np.array_equal(eff.numpy(), want_eff)
    assert np.array_equal(got[0], want[0])
    assert np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= 1e-12 * mag)
    assert not any(kernels.LAUNCHES.values())  # CPU tensors never launch


# ---------------------------------------------------------------- H16 as staged
# (staged jk dtype, jk offset, K, staged gids dtype, cap): config 8's shape
# (uint8 keys and gids), a negative offset whose first keys fall below 0, a
# uint16 key column with an offset over 300 groups, and int32 as it is.
STAGED_CASES = {
    "uint8": ("uint8", 0, 16, "uint8", 16),
    "uint8_offset": ("uint8", -3, 200, "uint8", 16),
    "uint16_offset": ("uint16", 1000, 40000, "uint16", 300),
    "int32": ("int32", 0, 1 << 20, "int32", 65536),
}


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
@pytest.mark.parametrize("S_l,S_r", [(0, 1), (1, 1), (2, 2)])
def test_join_agg_fold_plain_takes_staged_columns(case, S_l, S_r):
    """``jk`` as a ``Narrow`` (the staged bytes and their offset), the gids
    in their staged dtype and the left sums as separate columns give the
    int32 form's sums and effective mask bit for bit, keys outside [0, K)
    and gids outside [0, cap) included."""
    jk_dt, off, K, gid_dt, cap = STAGED_CASES[case]
    rng = np.random.default_rng(len(case) * 10 + S_l + S_r)
    n = 4000
    hi = min(K + 2, np.iinfo(jk_dt).max + off)
    keys = rng.integers(off, hi, n)
    gids = rng.integers(0, min(cap + 2, np.iinfo(gid_dt).max), n)
    mask = torch.from_numpy(rng.random(n) < 0.9)
    n_right = torch.from_numpy(rng.integers(0, 4, K).astype(np.float64))
    left = rng.normal(0, 1e3, (S_l, n))
    right = torch.from_numpy(rng.normal(0, 1e3, (S_r, K)))
    got = torch.zeros((1 + S_l + S_r, cap), dtype=torch.float64)
    want = torch.zeros_like(got)
    eff_got = torch.empty(n, dtype=torch.bool)
    eff_want = torch.empty_like(eff_got)
    staged_jk = torch.from_numpy((keys - off).astype(jk_dt))
    segment.join_agg_fold(segment.Narrow(staged_jk, off), torch.from_numpy(gids.astype(gid_dt)),
                          mask, n_right, [torch.from_numpy(r) for r in left], right, got, eff_got)
    segment.join_agg_fold(torch.from_numpy(keys.astype(np.int32)),
                          torch.from_numpy(gids.astype(np.int32)), mask, n_right,
                          torch.from_numpy(left), right, want, eff_want)
    assert torch.equal(eff_got, eff_want)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert int(eff_want.sum()) > 0


def test_join_agg_lane_hands_h16_its_staged_columns(monkeypatch):
    """The lane's fold hands H16 the join keys as staged (a ``Narrow`` of
    uint8 over these 40 keys), the gids as staged (uint8 over 3 services)
    and the left sums as separate columns, with no conversion of its own;
    the results equal the reference's join-aggregate lane (``run_ref``)."""
    seen = []
    fold = segment.join_agg_fold

    def spy(jk, gids, mask, n_right, left_vals, *rest):
        seen.append((jk, gids.dtype, left_vals))
        return fold(jk, gids, mask, n_right, left_vals, *rest)

    monkeypatch.setattr(segment, "join_agg_fold", spy)
    q = LANE_CASES["decomposition"]
    tables = _tables()
    got, lanes = run_port(tables, q)
    want, ref_took, _ = run_ref(tables, q)
    assert lanes == {"join_agg": 1} and ref_took
    assert seen
    for jk, gid_dtype, left_vals in seen:
        assert isinstance(jk, segment.Narrow) and jk.values.dtype == torch.uint8
        assert gid_dtype == torch.uint8
        assert isinstance(left_vals, list) and len(left_vals) == 1
    assert_rows_match(got, want)
