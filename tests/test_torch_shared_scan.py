"""Predicate-batched shared scans in the port (K16): the coordinator
(pixie_tpu_torch/serving/shared_scan.py), the predicate normalizer
(``normalize_predicates`` in parallel/pipeline.py), the batched fold
(``DeviceExecutor._run_program_batched``) and the plain versions of H22 and
H23 (ops/batched.py), against the reference and against the port's own
serial fold, on the CPU (``device="cpu"``: the kernels' plain versions).

Contracts: the normalizer's terms equal the reference's, term for term (or
both refuse). Concurrent and batched results are bit for bit the port's
serial results. The port against the reference's ``MeshExecutor`` (run
serially): counts exact, f64 sums within 1e-12 * sum |v|, the group set and
order equal. Every thread joins on a timeout; a hung thread fails.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.engine import Carnot as RefCarnot
from pixie_tpu.exec.expression_evaluator import ExpressionEvaluator as RefEvaluator
from pixie_tpu.parallel import MeshExecutor
from pixie_tpu.parallel.pipeline import normalize_predicates as ref_normalize
from pixie_tpu.plan.expressions import (
    ColumnRef as RefCol, Constant as RefConst, FuncCall as RefCall,
)
from pixie_tpu.table.column import StringDictionary as RefDict
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf.builtins import register_all as ref_register_all
from pixie_tpu.udf.registry import Registry as RefRegistry
from pixie_tpu_torch.engine import Carnot
from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
from pixie_tpu_torch.ops import batched, pred_edges, segment
from pixie_tpu_torch.parallel import DeviceExecutor
from pixie_tpu_torch.parallel.pipeline import normalize_predicates
from pixie_tpu_torch.plan.expressions import ColumnRef, Constant, FuncCall
from pixie_tpu_torch.serving import shared_scan
from pixie_tpu_torch.serving.shared_scan import SharedScanCoordinator
from pixie_tpu_torch.table.column import StringDictionary
from pixie_tpu_torch.types import DataType, Relation, SemanticType
from pixie_tpu_torch.udf.builtins import register_all
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.utils import flags, metrics_registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

JOIN_S = 60  # every thread joins within this many seconds
F, I, B, T, S = (DataType.FLOAT64, DataType.INT64, DataType.BOOLEAN,
                 DataType.TIME64NS, DataType.STRING)
REF = RefRegistry()
ref_register_all(REF)
PORT = Registry()
register_all(PORT)


def _join_all(threads) -> None:
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# -- the coordinator (tests/test_serving.py:189-320, :830-931) ---------------

@pytest.fixture
def window():
    def set_ms(ms: float) -> None:
        flags.set("shared_scan_window_ms", ms)
    yield set_ms
    flags.reset("shared_scan_window_ms")
    shared_scan.clear_queue_depth_fn()


def test_coordinator_rung1_coalesces_same_key(window):
    window(100.0)
    coord = SharedScanCoordinator()
    calls, results = [], []
    barrier = threading.Barrier(4)

    def compute():
        calls.append(1)
        return ("merged", 42)

    def run():
        barrier.wait()
        results.append(coord.run(("k",), compute))

    _join_all([threading.Thread(target=run) for _ in range(4)])
    assert len(calls) == 1 and results == [("merged", 42)] * 4
    assert coord.run(("a",), lambda: 1) == 1 and coord.run(("b",), lambda: 2) == 2


@pytest.mark.parametrize("distinct", [3, 2])
def test_coordinator_rung2_assembles_slots(window, distinct):
    """Distinct exact keys sharing a batch key become the slots of ONE
    compute_batch call, each receiving its own result; identical exact keys
    share a slot (4 callers over 2 keys: width 2)."""
    window(150.0)
    coord = SharedScanCoordinator()
    callers = 3 if distinct == 3 else 4
    calls, results = [], {}
    lock = threading.Lock()
    barrier = threading.Barrier(callers)

    def compute_batch(slot_terms):
        calls.append(list(slot_terms))
        return [("slot", tuple(t)) for t in slot_terms]

    def run(i):
        barrier.wait()
        k = i % distinct
        out = coord.run(("exact", k), lambda: ("solo", k), batch_key=("batch",),
                        terms=[("i", "c", 0, k, 0.0, ())], compute_batch=compute_batch)
        with lock:
            results[i] = out

    _join_all([threading.Thread(target=run, args=(i,)) for i in range(callers)])
    assert len(calls) == 1 and len(calls[0]) == distinct
    for i, out in results.items():
        assert out == ("slot", (("i", "c", 0, i % distinct, 0.0, ()),))


def test_coordinator_leader_error_fails_followers_whose_solo_fails(window):
    window(100.0)
    coord = SharedScanCoordinator()
    errors = []
    barrier = threading.Barrier(3)

    def compute():
        raise RuntimeError("boom")

    def run():
        barrier.wait()
        try:
            coord.run(("k",), compute)
        except RuntimeError as e:
            errors.append(str(e))

    _join_all([threading.Thread(target=run) for _ in range(3)])
    assert errors == ["boom"] * 3


def test_coordinator_followers_detach_solo_when_leader_killed(window):
    window(150.0)
    coord = SharedScanCoordinator()
    detached = metrics_registry().counter("serving_shared_scan_follower_detach_total")
    d0 = detached.total()
    results, errors = {}, []
    barrier = threading.Barrier(4)

    def killed(*_):
        raise RuntimeError("leader killed mid-batch")

    def leader():
        barrier.wait()
        try:
            coord.run(("leader",), killed, batch_key=("b",),
                      terms=[("i", "c", 0, 1, 0.0, ())], compute_batch=killed)
        except RuntimeError as e:
            errors.append(str(e))

    def follower(i):
        barrier.wait()
        time.sleep(0.02)  # join the leader's open window

        def must_not_lead(_terms):
            raise AssertionError("followers must not lead this batch")

        results[i] = coord.run((f"f{i}",), lambda: ("solo", i), batch_key=("b",),
                               terms=[("i", "c", 0, 10 + i, 0.0, ())],
                               compute_batch=must_not_lead)

    _join_all([threading.Thread(target=leader)]
              + [threading.Thread(target=follower, args=(i,)) for i in range(3)])
    assert errors == ["leader killed mid-batch"]
    assert results == {i: ("solo", i) for i in range(3)}
    assert detached.total() - d0 == 3


def test_coordinator_window_skipped_when_queue_empty(window):
    window(300.0)
    coord = SharedScanCoordinator()
    shared_scan.set_queue_depth_fn(lambda: 0)
    t0 = time.perf_counter()
    assert coord.run(("a",), lambda: 1) == 1
    assert time.perf_counter() - t0 < 0.25
    shared_scan.set_queue_depth_fn(lambda: 5)
    t0 = time.perf_counter()
    assert coord.run(("b",), lambda: 2) == 2
    assert time.perf_counter() - t0 >= 0.3


# -- the normalizer against the reference's ----------------------------------

REL_COLS = [("status", I), ("latency", F), ("lat32", F), ("service", S), ("ok", B),
            ("time_", T), ("req_path", S), ("code", I)]
# Staged dtypes: status narrowed to uint16, lat32 staged as f32, code an
# int-dictionary cell column.
STAGED = {"status": np.uint16, "latency": np.float64, "lat32": np.float32,
          "service": np.int32, "ok": np.bool_, "time_": np.int64, "req_path": np.int32,
          "code": np.uint8}
TORCH_DT = {np.uint16: torch.uint16, np.float64: torch.float64, np.float32: torch.float32,
            np.int32: torch.int32, np.bool_: torch.bool, np.int64: torch.int64,
            np.uint8: torch.uint8}
DICTS = {"service": ["svc-a", "svc-b", "svc-c"],
         "req_path": ["/api/v1/x", "/healthz", "/api/v2/y", "/readyz"]}


def _tree(pkg: str, spec):
    """Build one predicate tree in a package from a nested spec: ("col",
    name), ("lit", value, type) or (func, *args)."""
    col, const, call = (ColumnRef, Constant, FuncCall) if pkg == "port" else (
        RefCol, RefConst, RefCall)
    if spec[0] == "col":
        return col(spec[1])
    if spec[0] == "lit":
        return const(spec[1], spec[2] if pkg == "port" else RefDT[spec[2].name])
    return call(spec[0], tuple(_tree(pkg, a) for a in spec[1:]))


def _c(name):
    return ("col", name)


def _l(v, t):
    return ("lit", v, t)


NORM_CASES = {
    "int_eq": [("equal", _c("status"), _l(200, I))],
    "int_ne": [("notEqual", _c("status"), _l(404, I))],
    "int_lt_const_left": [("lessThan", _l(300, I), _c("status"))],
    "int_ge": [("greaterThanEqual", _c("status"), _l(400, I))],
    "time_le_const_left": [("lessThanEqual", _l(5_000, T), _c("time_"))],
    "float_gt": [("greaterThan", _c("latency"), _l(2e7, F))],
    "float_eq_const_left": [("equal", _l(0.1, F), _c("latency"))],
    "float_ne": [("notEqual", _c("latency"), _l(-0.0, F))],
    "f32_threshold": [("greaterThan", _c("lat32"), _l(0.1, F))],
    "string_eq": [("equal", _c("service"), _l("svc-b", S))],
    "string_ne_const_left": [("notEqual", _l("svc-a", S), _c("service"))],
    "string_unseen": [("equal", _c("service"), _l("svc-zz", S))],
    "int_out_of_range_refused": [("equal", _c("status"), _l(2**64, I))],
    "bare_bool": [_c("ok")],
    "conjunction": [("logical_and", ("greaterThan", _c("latency"), _l(1e7, F)),
                     ("equal", _c("status"), _l(200, I)))],
    "two_predicates": [("equal", _c("status"), _l(500, I)),
                       ("lessThan", _c("latency"), _l(5e7, F))],
    "int_in_list": [("logical_or", ("logical_or", ("equal", _c("status"), _l(404, I)),
                                    ("equal", _c("status"), _l(200, I))),
                     ("equal", _l(404, I), _c("status")))],
    "string_in_list_unseen": [("logical_or", ("equal", _c("service"), _l("svc-c", S)),
                               ("equal", _c("service"), _l("nope", S)))],
    "float_in_list_refused": [("logical_or", ("equal", _c("latency"), _l(1.0, F)),
                               ("equal", _c("latency"), _l(2.0, F)))],
    "mixed_in_list_refused": [("logical_or", ("equal", _c("status"), _l(200, I)),
                               ("equal", _c("code"), _l(1, I)))],
    "lut_bare_contains": [("contains", _c("req_path"), _l("/api", S))],
    "lut_cmp_length": [("greaterThan", ("length", _c("req_path")), _l(8, I))],
    "lut_cmp_const_left": [("lessThanEqual", _l(7, I), ("length", _c("req_path")))],
    "int_dict_refused": [("equal", _c("code"), _l(3, I))],
    "column_vs_column_refused": [("greaterThan", _c("latency"), _c("lat32"))],
    "computed_refused": [("greaterThan", ("add", _c("latency"), _c("latency")), _l(5.0, F))],
}


class _Shim:
    def __init__(self, blocks, int_dicts):
        self.blocks, self.int_dicts = blocks, int_dicts


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_normalizer_matches_reference(case):
    specs = NORM_CASES[case]
    out = {}
    for pkg in ("port", "ref"):
        preds = [_tree(pkg, sp) for sp in specs]
        if pkg == "port":
            rel = Relation.of(*REL_COLS)
            ev = ExpressionEvaluator([(f"pred{i}", p) for i, p in enumerate(preds)], rel, PORT)
            dicts = {k: StringDictionary() for k in DICTS}
            blocks = {c: torch.zeros(0, dtype=TORCH_DT[dt]) for c, dt in STAGED.items()}
            norm = normalize_predicates
        else:
            rel = RefRelation.of(*[(n, RefDT[t.name]) for n, t in REL_COLS])
            ev = RefEvaluator([(f"pred{i}", p) for i, p in enumerate(preds)], rel, REF)
            dicts = {k: RefDict() for k in DICTS}
            blocks = {c: np.zeros(0, dt) for c, dt in STAGED.items()}
            norm = ref_normalize
        for k, vals in DICTS.items():
            dicts[k].encode(np.asarray(vals, dtype=object))
        aux = {}
        for p in preds:
            aux.update(ev.build_aux(p, dicts))
        out[pkg] = norm(preds, ev, _Shim(blocks, {"code": np.array([1, 3, 7])}), aux)
    assert out["port"] == out["ref"]
    if case.endswith("refused"):
        assert out["port"] is None
    else:
        assert out["port"] is not None


# -- H22 and H23's plain versions against numpy ------------------------------

INT64_MIN, INT64_MAX = pred_edges.INT64_MIN, pred_edges.INT64_MAX


def _np_cmp(op, v, t):
    return [np.equal, np.not_equal, np.less, np.less_equal, np.greater,
            np.greater_equal][op](v, t)


_edge_columns = pred_edges.edge_columns
SLOT_CASES = pred_edges.SLOT_CASES


@pytest.mark.parametrize("case", range(len(SLOT_CASES)))
def test_slot_masks_plain_matches_numpy(case):
    n = 5000
    cols = _edge_columns(n)
    base = np.random.default_rng(case).random(n) < 0.9
    slot_terms = SLOT_CASES[case]
    table = batched.build_term_table(slot_terms, {c: a.dtype for c, (a, _) in cols.items()})
    assert table.B >= len(slot_terms) and table.T >= max(len(t) for t in slot_terms)
    got = batched.slot_masks(
        [torch.from_numpy(cols[c][0]) for c in table.columns],
        [cols[c][1] for c in table.columns], torch.from_numpy(base), table,
    ).numpy().view(np.uint32)
    want = np.zeros(n, np.uint32)
    for s, terms in enumerate(slot_terms):
        ok = base.copy()
        for stack, c, op, thr_i, thr_f, vals in terms:
            a, off = cols[c]
            v = a.astype(np.float64) if stack == "f" else a.astype(np.int64) + np.int64(off)
            if op == 6:
                ok &= np.isin(v, np.asarray(vals, np.int64))
            else:
                ok &= _np_cmp(op, v, thr_f if stack == "f" else np.int64(thr_i))
        want |= ok.astype(np.uint32) << np.uint32(s)
    assert np.array_equal(got, want)


def test_term_table_checks_stacks_and_limits():
    with pytest.raises(ValueError):
        batched.build_term_table([[("i", "x", 0, 1, 0.0, ())]], {"x": np.float64})
    assert not batched.fits([[]] * (batched.MAX_SLOTS + 1))
    runs = batched.split_batch([[("i", f"c{s}", 0, 1, 0.0, ())] for s in range(40)])
    assert [len(r) for r in runs] == [16, 16, 8]  # at most 16 distinct columns a table


def _edge_soak(B: int = 7) -> list:
    """The soak's families (B 7) or wide_terms(B) on the edge columns."""
    if B == 7:
        return pred_edges.soak_terms("u16", "f64", -69_800, 2.0)
    return pred_edges.wide_terms(B, "u16", "f64", -69_800, 2.0, 1.0)


# (slot terms, the columns' maker, distinct terms, the lists' forms)
COMPILE_CASES = [
    (SLOT_CASES[0], _edge_columns, 3, []),
    (SLOT_CASES[1], _edge_columns, 5, []),
    (SLOT_CASES[2], _edge_columns, 5, ["bitmap", "bitmap"]),
    (SLOT_CASES[3], _edge_columns, 32, []),
    (_edge_soak(7), _edge_columns, 6, ["bitmap"]),
    (_edge_soak(16), _edge_columns, 9, ["bitmap", "bitmap"]),
    (_edge_soak(32), _edge_columns, 25, ["bitmap", "bitmap"]),
    (pred_edges.sixteen_terms(), pred_edges.sixteen_columns, 16, ["bitmap"] * 2),
    (pred_edges.lists_terms(), _edge_columns, 4, ["sorted", "bitmap", "sorted", "global"]),
]


def _program_bits(cols: list, offsets: list, base: torch.Tensor, table) -> torch.Tensor:
    """A torch model of H22 over ``table.prog``: each distinct term once
    (compares as (lt, eq, gt) selections, negated for !=; lists as their
    form lays them out), a false term's ``need`` into the row's fail mask,
    then base ? slot_on & ~fail : 0, as int32."""
    prog = table.prog
    words = prog.lists.numpy().view(np.uint64)
    vals = [batched._widen(c, int(o)) for c, o in zip(cols, offsets)]
    fail = torch.zeros(base.shape[0], dtype=torch.int64)
    for col, code, thr, form, off, ln, lo, need in prog.terms.numpy().tolist():
        v = vals[col]
        if code == batched.CODE_IN:
            if form == batched.LIST_BITMAP:
                at = (v - lo).numpy()  # wraps as the kernel's unsigned difference
                inside = (at >= 0) & (at < ln)
                idx = np.where(inside, at, 0)
                bit = (words[off + (idx >> 6)] >> (idx & 63).astype(np.uint64)) & np.uint64(1)
                ok = torch.from_numpy(inside & (bit == 1))
            else:
                members = torch.from_numpy(prog.lists.numpy()[off : off + ln])
                at = torch.searchsorted(members, v).clamp(max=max(ln - 1, 0))
                ok = (members[at] == v) if ln else torch.zeros_like(v, dtype=torch.bool)
        else:
            op = code - batched.CODE_FLOAT if code >= batched.CODE_FLOAT else code
            t = float(np.int64(thr).view(np.float64)) if code >= batched.CODE_FLOAT else thr
            hit = ((v < t) & (op in (2, 3))) | ((v == t) & (op in (0, 1, 3, 5))) \
                | ((v > t) & (op in (4, 5)))
            ok = hit ^ (op == 1)
        fail |= torch.where(ok, 0, need)
    bits = torch.where(base, table.slot_on & ~fail, 0)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)


@pytest.mark.parametrize("case", range(len(COMPILE_CASES)))
def test_compile_terms_model_equals_plain(case):
    """compile_terms keeps each distinct active term once, sorted by column,
    with the slots that hold it; running the program (slot_on & ~OR need[u]
    of the false terms) gives slot_masks_plain's bits bit for bit."""
    slot_terms, make_cols, distinct, forms = COMPILE_CASES[case]
    n = 5000
    cols = make_cols(n)
    base = torch.from_numpy(np.random.default_rng(case + 40).random(n) < 0.9)
    table = batched.build_term_table(slot_terms, {c: a.dtype for c, (a, _) in cols.items()})
    prog = table.prog
    assert prog.num_terms == distinct
    assert prog.forms == forms
    terms = prog.terms.numpy()
    assert np.all(np.diff(terms[:, 0]) >= 0)  # sorted by column
    assert int(np.bitwise_or.reduce(terms[:, 7], initial=0)) & ~table.slot_on == 0
    for s, st in enumerate(slot_terms):  # a slot's terms are the terms that need it
        assert int(((terms[:, 7] >> s) & 1).sum()) == len(set(map(repr, st)))
    assert prog.shared_words <= batched.LIST_SHARED_WORDS
    tcols = [torch.from_numpy(cols[c][0]) for c in table.columns]
    offs = [cols[c][1] for c in table.columns]
    want = batched.slot_masks_plain(tcols, offs, base, table)
    assert torch.equal(_program_bits(tcols, offs, base, table), want)


def test_compile_terms_shares_a_repeated_list():
    """wide_terms(32): one 1024-member list in 25 slots is one term (its
    need holds slots 7..31) and one bitmap of 32 words."""
    table = batched.build_term_table(_edge_soak(32), {"u16": np.uint16, "f64": np.float64})
    terms = table.prog.terms.numpy()
    lists = terms[terms[:, 1] == batched.CODE_IN]
    big = lists[lists[:, 5] == 2047]
    assert len(big) == 1 and int(big[0, 7]) == ((1 << 32) - 1) & ~((1 << 7) - 1)
    # and the soak's 2-member list (span 205): a bitmap of 4 words
    assert int(big[0, 3]) == batched.LIST_BITMAP and table.prog.shared_words == 32 + 4


def test_batched_segment_sums_plain_is_the_serial_reductions():
    rng = np.random.default_rng(3)
    n, S, Bn = 3000, 16, 5
    gids = torch.from_numpy(rng.integers(0, S, n).astype(np.int32))
    bits = torch.from_numpy(rng.integers(0, 1 << Bn, n).astype(np.int32))
    irows = torch.from_numpy(rng.integers(INT64_MIN, INT64_MAX, (2, n), dtype=np.int64))
    frows = torch.from_numpy(rng.normal(0, 1e6, (3, n)))
    ti, tf = batched.batched_segment_sums(irows, frows, gids, bits, Bn, S)
    for s in range(Bn):
        m = batched.slot_mask(bits, s)
        assert torch.equal(ti[s], segment.segment_rows_sum_i64_plain(irows, gids, m, S))
        for f in range(3):
            want = segment.segment_sum_f64_plain(frows[f], gids, m, S)
            assert torch.equal(tf[s, f].view(torch.int64), want.view(torch.int64))


# -- end to end on the CPU ----------------------------------------------------

def _pred_query(pred, names=("n", "total")) -> str:
    filt = f"df = df[{pred}]\n" if pred else ""
    return ("df = px.DataFrame(table='http_events')\n" + filt
            + "s = df.groupby(['service']).agg(\n"
            f"    {names[0]}=('time_', px.count),\n"
            f"    {names[1]}=('latency', px.sum),\n"
            ")\npx.display(s, 'out')\n")


# The reference test's PRED_QUERIES (tests/test_serving.py:821-827) and the
# soak's seven families (tools/soak_serving.py:56-83) in both name variants;
# the widest query first, so its superset staging serves every query.
PRED_QUERIES = [
    _pred_query("df.resp_status == 200"),
    _pred_query("df.resp_status == 400", names=("cnt", "s")),
    _pred_query("df.resp_status != 200"),
    _pred_query("df.latency > 25.0"),
    _pred_query("df.service == 'a'"),
]
SOAK_PREDS = ("df.resp_status == 200", "df.resp_status == 404", "df.resp_status == 500",
              "df.resp_status != 200", "df.latency > 20000000.0",
              "df.resp_status in [200, 404]", None)
SOAK_QUERIES = [_pred_query(p, nm) for p in SOAK_PREDS for nm in (("n", "total"), ("cnt", "s"))]


def _events(n: int = 6000, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n, dtype=np.int64) * 10**6,
        "service": rng.choice(["a", "b", "c", "d"], n, p=[0.4, 0.3, 0.2, 0.1]).astype(object),
        "resp_status": rng.choice([200, 400, 404, 500], n, p=[0.7, 0.1, 0.1, 0.1]),
        "latency": np.where(rng.random(n) < 0.5, rng.exponential(30.0, n),
                            rng.exponential(3e7, n)),
    }


def _port(data: dict, block_rows: int = 1024):
    ex = DeviceExecutor(device="cpu", block_rows=block_rows)
    c = Carnot(device_executor=ex)
    rel = Relation.of(("time_", T, SemanticType.ST_TIME_NS), ("service", S),
                      ("resp_status", I), ("latency", F))
    c.table_store.create_table("http_events", rel).write_pydict(dict(data))
    return c, ex


def _ref(data: dict):
    ex = MeshExecutor(mesh=Mesh(np.array(jax.devices()[:1]), ("d",)), block_rows=1024)
    c = RefCarnot(device_executor=ex)
    rel = RefRelation.of(("time_", RefDT.TIME64NS), ("service", RefDT.STRING),
                         ("resp_status", RefDT.INT64), ("latency", RefDT.FLOAT64))
    c.table_store.create_table("http_events", rel).write_pydict(dict(data))
    return c


def _identical(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for col in a:
        av, bv = np.asarray(a[col]), np.asarray(b[col])
        assert av.dtype == bv.dtype, col
        if av.dtype.kind == "f":
            assert np.array_equal(av.view(np.int64), bv.view(np.int64)), col
        else:
            assert np.array_equal(av, bv), col


@pytest.fixture
def batching():
    flags.set("shared_scans", True)
    flags.set("shared_scan_predicate_batching", True)
    flags.set("shared_scan_window_ms", 200.0)
    yield
    for f in ("shared_scan_window_ms", "shared_scan_predicate_batching", "shared_scans"):
        flags.reset(f)


def _concurrent(c, queries: list, now_ns=None) -> list:
    results, errors = [None] * len(queries), []
    barrier = threading.Barrier(len(queries))

    def run(i):
        try:
            barrier.wait()
            results[i] = c.execute_query(queries[i], now_ns=now_ns).table("out")
        except Exception as e:  # the assertion below shows it
            errors.append(e)

    _join_all([threading.Thread(target=run, args=(i,)) for i in range(len(queries))])
    assert not errors, errors
    return results


@pytest.mark.parametrize("name", ["pred_queries", "soak_families"])
def test_concurrent_batched_bit_identical_to_serial(batching, name):
    queries = PRED_QUERIES if name == "pred_queries" else SOAK_QUERIES
    queries = sorted(queries, key=lambda q: "resp_status" not in q)
    c, _ = _port(_events())
    serials = [c.execute_query(q).table("out") for q in queries]
    width = metrics_registry().histogram("serving_shared_scan_batch_width")
    before = sum(width.merged_counts()[1:])
    batched_q = metrics_registry().counter("serving_shared_scan_predicate_batched_queries_total")
    b0 = batched_q.value()
    for serial, got in zip(serials, _concurrent(c, queries)):
        _identical(serial, got)
    assert sum(width.merged_counts()[1:]) > before  # a dispatch of width > 1
    assert batched_q.value() > b0


def test_port_matches_reference_mesh_executor():
    data = _events()
    c, _ = _port(data)
    rc = _ref(data)
    queries = sorted(PRED_QUERIES + SOAK_QUERIES, key=lambda q: "resp_status" not in q)
    for q in queries:
        got, want = c.execute_query(q).table("out"), rc.execute_query(q).table("out")
        assert list(got) == list(want)
        assert list(got["service"]) == list(want["service"])  # group set and order
        names = list(got)
        cnt, tot = names[1], names[2]
        assert np.array_equal(np.asarray(got[cnt]), np.asarray(want[cnt]))
        bound = np.zeros(len(got[tot]))
        lat = np.abs(data["latency"])
        svc = np.asarray(data["service"])
        for i, s in enumerate(got["service"]):
            bound[i] = 1e-12 * lat[svc == s].sum()
        assert np.all(np.abs(np.asarray(got[tot]) - np.asarray(want[tot])) <= bound)


class _Capture:
    """Stands in for an executor's coordinator: runs each query solo and
    keeps what it offered (its keys, terms and compute_batch)."""

    def __init__(self):
        self.calls = []

    def run(self, key, compute, batch_key=None, terms=None, compute_batch=None):
        solo = compute()
        self.calls.append(dict(key=key, batch_key=batch_key, terms=terms,
                               compute_batch=compute_batch, solo=solo))
        return solo


def _outputs_identical(a, b) -> None:
    (vals_a, pres_a), cap_a = a
    (vals_b, pres_b), cap_b = b
    assert cap_a == cap_b and np.array_equal(pres_a, pres_b)
    assert len(vals_a) == len(vals_b)
    for x, y in zip(vals_a, vals_b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


def _batched_call(c, ex, queries: list, now_ns=None) -> tuple:
    """Each query once warm (the widest first stages what all read), then
    again with the coordinator captured; then ONE ``_run_program_batched``
    call over every query's terms. Returns (captured calls, slot results)."""
    for q in queries:
        c.execute_query(q, now_ns=now_ns)
    cap = _Capture()
    ex._shared_scans = cap
    for q in queries:
        c.execute_query(q, now_ns=now_ns)
    ex._shared_scans = SharedScanCoordinator()
    calls = cap.calls
    assert len(calls) == len(queries)
    assert all(k["terms"] is not None for k in calls)
    assert len({k["batch_key"] for k in calls}) == 1
    assert len({k["key"] for k in calls}) == len(queries)
    return calls, calls[0]["compute_batch"]([k["terms"] for k in calls])


def _agg_query(pred: str, aggs: str, groups: str = "'service'") -> str:
    return ("df = px.DataFrame(table='http_events')\n"
            f"df = df[{pred}]\n"
            f"s = df.groupby([{groups}]).agg({aggs})\n"
            "px.display(s, 'out')\n")


SUMS = "n=('time_', px.count), total=('latency', px.sum), st=('resp_status', px.sum), m=('latency', px.mean)"
MINMAX_CM = ("lo=('latency', px.min), hi=('latency', px.max), f=('resp_status', px.count_min), "
             "t=('latency', px.quantiles_tdigest)")
BATCH_CASES = {
    # B = 3 (padded to 4) and 5 (padded to 8).
    "sums_b3": [_agg_query(p, SUMS) for p in (
        "df.resp_status == 200", "df.latency > 25.0", "df.resp_status in [404, 500]")],
    # 16 (service, status) groups on the host key plan, 8 a pass.
    "multi_pass_b5": [_agg_query(p, SUMS, "'service', 'resp_status'") for p in (
        "df.service == 'b'", "df.resp_status == 200", "df.resp_status != 200",
        "df.latency > 1000.0", "df.resp_status >= 404")],
    # Slot 1 keeps no row of service 'd', slot 2 no row at all.
    "empty_groups_b3": [_agg_query(p, SUMS) for p in (
        "df.resp_status == 200", "df.service != 'd'", "df.latency < 0.0")],
    # resp_status is read by no predicate: the cell lane, per slot.
    "sketch_cell_lane_b3": [_agg_query(p, "q=('latency', px.quantiles), "
                                          "u=('resp_status', px.approx_count_distinct)")
                            for p in ("df.latency > 1e1", "df.latency > 2e7", "df.latency > 4e7")],
    # count_min of a column no predicate reads takes the cell lane...
    "minmax_countmin_b5": [_agg_query(p, MINMAX_CM) for p in (
        "df.latency > 30.0", "df.service == 'c'", "df.latency < 1e7", "df.service != 'a'",
        "df.latency >= 5.0")],
    # ... and of a column the predicates read, its row path (H6), per slot.
    "countmin_row_path_b3": [_agg_query(p, MINMAX_CM) for p in (
        "df.resp_status == 200", "df.resp_status == 404", "df.resp_status in [200, 500]")],
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_run_program_batched_slots_equal_solo(case):
    queries = BATCH_CASES[case]
    if case == "multi_pass_b5":
        flags.set("device_group_state_budget_mb", 1e-4)
    try:
        c, ex = _port(_events())
        segment.reduce_lanes(reset=True)
        calls, slots = _batched_call(c, ex, queries)
    finally:
        flags.reset("device_group_state_budget_mb")
    assert len(slots) == len(queries)
    for call, slot in zip(calls, slots):
        _outputs_identical(call["solo"], slot)
    if case == "multi_pass_b5":
        assert slots[0][1] == 8 and calls[0]["key"][3][4] == 2  # capacity 8, two passes
    if case == "empty_groups_b3":
        d = c.table_store.get_table("http_events").dictionaries["service"].lookup("d")
        (_, pres1), _ = slots[1]
        (_, pres2), _ = slots[2]
        assert pres1[d] == 0 and np.delete(pres1[:4], d).min() > 0
        assert not pres2.any()
        got = c.execute_query(queries[1]).table("out")
        assert "d" not in list(got["service"])
    if case == "sketch_cell_lane_b3":
        assert segment.reduce_lanes().get("cell_lane", 0) > 0


def test_unnormalizable_predicate_takes_rung_one_only(batching):
    q = _pred_query("df.latency + df.latency > 50.0")
    c, ex = _port(_events())
    serial = c.execute_query(q).table("out")
    cap = _Capture()
    ex._shared_scans = cap
    c.execute_query(q)
    assert cap.calls[0]["terms"] is None and cap.calls[0]["batch_key"] is None
    ex._shared_scans = SharedScanCoordinator()
    width = metrics_registry().histogram("serving_shared_scan_batch_width")
    before = width.merged_counts()
    for got in _concurrent(c, [q, q, q]):
        _identical(serial, got)
    after = width.merged_counts()
    assert after[1:] == before[1:] and after[0] > before[0]  # width 1 only


# -- the concurrency repairs --------------------------------------------------

@pytest.mark.parametrize("counter", ["lanes", "launches", "cold_profile"])
def test_shared_counters_lose_no_update_under_threads(counter):
    """32 threads (more than the cores) add to one shared counter with a
    tiny switch interval: the total is exact only if the read-modify-write
    is atomic."""
    import sys

    from pixie_tpu_torch.ops import kernels
    from pixie_tpu_torch.parallel import staging

    add, read = {
        "lanes": (lambda: segment.lane_count("stress"),
                  lambda: segment.reduce_lanes().get("stress", 0)),
        "launches": (lambda: kernels.count_launch("pred_slot_masks"),
                     lambda: kernels.LAUNCHES["pred_slot_masks"]),
        "cold_profile": (lambda: staging.profile_add("stress", 1.0),
                         lambda: staging.COLD_PROFILE.get("stress", 0.0)),
    }[counter]
    threads, per = 32, 2000
    start = read()
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait()
        for _ in range(per):
            add()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _join_all([threading.Thread(target=work) for _ in range(threads)])
    finally:
        sys.setswitchinterval(old)
    assert read() - start == threads * per
    segment.reduce_lanes(reset=True)
    staging.reset_cold_profile()
    kernels.reset_launches()


def _table2(c) -> None:
    rng = np.random.default_rng(5)
    n = 5000
    rel = Relation.of(("k", I), ("v", F), ("w", I))
    c.table_store.create_table("t2", rel).write_pydict({
        "k": rng.integers(0, 50, n), "v": rng.normal(0, 1, n), "w": rng.integers(0, 9, n)})


Q2 = [
    "df = px.DataFrame(table='t2')\ns = df.groupby(['k']).agg(n=('v', px.count), "
    "s=('v', px.sum))\npx.display(s, 'out')\n",
    "df = px.DataFrame(table='t2')\ndf = df[df.w > 3]\ns = df.groupby(['k']).agg("
    "m=('v', px.max), u=('w', px.approx_count_distinct))\npx.display(s, 'out')\n",
    "df = px.DataFrame(table='t2')\ns = df.groupby(['w']).agg(a=('v', px.mean))\n"
    "px.display(s, 'out')\n",
]


def test_staged_cache_walks_while_other_threads_insert():
    """Superset lookups walk the staged cache while other threads insert
    and evict: no walk may see the OrderedDict change under it."""
    import sys

    flags.set("staged_cache_cap", 16)
    try:
        ex = DeviceExecutor(device="cpu")
    finally:
        flags.reset("staged_cache_cap")

    def key(cols):
        return ("t", (0, 1), cols, None, None, 1024, "k", 1, (), ())

    for i in range(16):
        ex._staged_insert(key((f"w{i}",)), object())
    errors = []

    def walker():
        try:
            for _ in range(3000):
                assert ex._staged_lookup(key(("absent",)))[1] is None
        except BaseException as e:  # reported below
            errors.append(e)

    def writer(j):
        try:
            for i in range(3000):
                ex._staged_insert(key((f"c{j}_{i}",)), object())
        except BaseException as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _join_all([threading.Thread(target=walker) for _ in range(6)]
                  + [threading.Thread(target=writer, args=(j,)) for j in range(6)])
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert len(ex._staged_cache) == 16


def test_concurrent_warm_and_cold_queries_with_evictions():
    """8 threads, warm and cold aggregates over two tables, a staged cache
    of one entry: every query evicts another's staging, so the caches are
    walked and changed from several threads at once. No thread raises and
    every result equals its serial one."""
    import sys

    flags.set("staged_cache_cap", 1)
    flags.set("keyplan_cache_cap", 1)
    flags.set("shared_scan_window_ms", 5.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        c, ex = _port(_events(), block_rows=512)
        _table2(c)
        queries = PRED_QUERIES[:3] + Q2 + [PRED_QUERIES[3], Q2[0]]
        serials = [c.execute_query(q).table("out") for q in queries]
        for _ in range(3):
            ex.clear_caches()
            for serial, got in zip(serials, _concurrent(c, queries)):
                _identical(serial, got)
    finally:
        sys.setswitchinterval(old)
        for f in ("staged_cache_cap", "keyplan_cache_cap", "shared_scan_window_ms"):
            flags.reset(f)
