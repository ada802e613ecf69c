"""The string and JSON scalar functions of the port against the reference's,
on the CPU: each overload called on the same numpy object arrays, and each
through both packages' host expression evaluators over a dictionary column
(the dict_compatible path: applied to the dictionary's values, gathered
through the codes). Exact, value for value.
"""

import numpy as np
import pytest
import torch

from pixie_tpu.exec.expression_evaluator import ExpressionEvaluator as RefEvaluator
from pixie_tpu.plan.expressions import ColumnRef as RefCol, Constant as RefConst, FuncCall as RefCall
from pixie_tpu.table.column import DictColumn as RefDictColumn, StringDictionary as RefDict
from pixie_tpu.table.row_batch import RowBatch as RefBatch
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf.builtins import register_all as ref_register_all
from pixie_tpu.udf.registry import Registry as RefRegistry
from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
from pixie_tpu_torch.plan.expressions import ColumnRef, Constant, FuncCall
from pixie_tpu_torch.table.column import DictColumn, StringDictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.builtins import register_all
from pixie_tpu_torch.udf.registry import Registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

REF = RefRegistry()
ref_register_all(REF)
PORT = Registry()
register_all(PORT)
S, I, F, B = DataType.STRING, DataType.INT64, DataType.FLOAT64, DataType.BOOLEAN

STRINGS = np.array([
    "", "svc-1", "svc-10", "/api/v1/users/123", "/api/v1/carts/7/items/42", "/healthz",
    "  padded  ", "MiXeD Case", "ünïcödé", "12", "-7", "3.5e2", "nan", "abc123def",
    '{"p50": 12.5, "p99": 40, "name": "x"}', '{"p50": "oops"}', "not json", "[1, 2]",
], dtype=object)

# (name, arg types, constant args after the string column)
CASES = [
    ("contains", (S, S), ("svc-1",)),
    ("length", (S,), ()),
    ("find", (S, S), ("/",)),
    ("substring", (S, I, I), (1, 4)),
    ("toLower", (S,), ()),
    ("toUpper", (S,), ()),
    ("trim", (S,), ()),
    ("strip", (S,), ()),
    ("replace", (S, S, S), ("/", "|")),
    ("startsWith", (S, S), ("/api",)),
    ("endsWith", (S, S), ("z",)),
    ("atoi", (S,), ()),
    ("atof", (S,), ()),
    ("string", (S,), ()),
    ("pluck", (S, S), ("name",)),
    ("pluck_int64", (S, S), ("p99",)),
    ("pluck_float64", (S, S), ("p50",)),
]
# Functions whose column argument is not the first (regex_*: the pattern
# comes first).
REGEX = [
    ("regex_match", (S, S), (r".*/[0-9]+",)),
    ("regex_replace", (S, S, S), (r"/[0-9]+", "/{id}")),
]


def _call(reg, name, types, args):
    dt = (lambda t: RefDT[t.name]) if reg is REF else (lambda t: t)
    return np.asarray(reg.lookup_scalar(name, [dt(t) for t in types]).fn(*args))


def _equal(got, want) -> None:
    assert got.dtype.kind == want.dtype.kind or {got.dtype.kind, want.dtype.kind} <= {"i", "u"}
    if want.dtype.kind == "f":
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert got.tolist() == want.tolist()


@pytest.mark.parametrize("name, types, consts", CASES + REGEX, ids=[c[0] for c in CASES + REGEX])
def test_string_function_matches_reference(name, types, consts):
    col_first = (name, types, consts) not in REGEX
    args = [STRINGS, *consts] if col_first else [consts[0], STRINGS, *consts[1:]]
    _equal(_call(PORT, name, types, args), _call(REF, name, types, args))
    # Through both host evaluators over a dictionary column.
    col, const, call = (ColumnRef, Constant, FuncCall)
    rcol, rconst, rcall = (RefCol, RefConst, RefCall)
    lit = lambda v, mk, dt: mk(v, dt.STRING if isinstance(v, str) else dt.INT64)
    exprs = [lit(c, const, DataType) for c in consts]
    rexprs = [lit(c, rconst, RefDT) for c in consts]
    if col_first:
        e, re_ = call(name, (col("s"), *exprs)), rcall(name, (rcol("s"), *rexprs))
    else:
        e = call(name, (exprs[0], col("s"), *exprs[1:]))
        re_ = rcall(name, (rexprs[0], rcol("s"), *rexprs[1:]))
    codes = np.random.default_rng(3).integers(0, len(STRINGS), 200).astype(np.int32)
    d, rd = StringDictionary(), RefDict()
    d.encode(STRINGS), rd.encode(STRINGS)
    batch = RowBatch(Relation.of(("s", S)), [DictColumn(codes, d)], eow=True, eos=True)
    rbatch = RefBatch(RefRelation.of(("s", RefDT.STRING)), [RefDictColumn(codes, rd)],
                      eow=True, eos=True)
    out_t = PORT.lookup_scalar(name, list(types)).out_type
    got = ExpressionEvaluator([("o", e)], batch.relation, PORT).evaluate(
        batch, Relation.of(("o", out_t))).columns[0]
    want = RefEvaluator([("o", re_)], rbatch.relation, REF).evaluate(
        rbatch, RefRelation.of(("o", RefDT[out_t.name]))).columns[0]
    if out_t == S:
        assert got.decode().tolist() == want.decode().tolist()
    else:
        _equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("t, values", [
    (I, np.array([0, -7, 2**63 - 1], np.int64)),
    (F, np.array([0.1, -2.5, 1e300, float("nan")])),
    (B, np.array([True, False])),
])
def test_string_of_numbers_matches_reference(t, values):
    _equal(_call(PORT, "string", (t,), [values]), _call(REF, "string", (t,), [values]))


def test_string_add_select_and_script_reference_match_reference():
    a = STRINGS[:6]
    b = STRINGS[6:12]
    _equal(_call(PORT, "add", (S, S), [a, b]), _call(REF, "add", (S, S), [a, b]))
    cond = np.array([True, False, True, False, True, False])
    _equal(_call(PORT, "select", (B, S, S), [cond, a, b]), _call(REF, "select", (B, S, S), [cond, a, b]))
    for k in range(5):
        types = (S, S) + (S,) * (2 * k)
        args = [a, "px/service"] + [f"v{j}" if j % 2 else a for j in range(2 * k)]
        _equal(_call(PORT, "script_reference", types, args),
               _call(REF, "script_reference", types, args))
