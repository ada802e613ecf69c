"""The scalar builtins of the port and H17's program compiler against the
reference, on the CPU.

Every scalar overload the port adds (math_ops' unaries, pow and log,
modulo and divide at their edges, time_ops' bin, DurationNanos and Time,
conditionals' numeric select) runs three ways on the same seeded numpy
inputs: the UDF on numpy arrays (the host exec graph), the UDF on CPU
tensors (the torch tree walk, ``device_eval``) and the compiled H17 program
through its plain interpreter (what the device fold runs); each is held
against the reference's jnp function on the same values.

Contracts (PERF.md): exact, NaN equal to NaN, for everything except the f64
transcendentals (ln, log2, log10, exp, pow, log(b, x)) and sqrt, which
agree within 2 ulp (Fault-12: XLA-CPU, numpy and torch round them
differently now and then). Every float -> int64 conversion saturates as
JAX's does (Fault-11: NaN -> 0, >= 2^63 -> INT64_MAX, <= -2^63 ->
INT64_MIN), pinned by the ``test_fault11_*`` cases. XLA-CPU reads an f64
subnormal as zero in these ops; the port keeps it, as numpy and CUDA do
(Fault-13, ``test_fault13_*``), so the shared inputs hold no subnormal. The program shapes of
service_stats.pxl's queries (Q1-Q4 of chip_smoke.py) run through the plain
interpreter, the torch tree walk and the reference's ``device_eval``.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.exec.expression_evaluator import ExpressionEvaluator as RefEvaluator
from pixie_tpu.plan.expressions import (
    ColumnRef as RefCol, Constant as RefConst, FuncCall as RefCall,
)
from pixie_tpu.table.column import StringDictionary as RefDict
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf.builtins import register_all as ref_register_all
from pixie_tpu.udf.registry import Registry as RefRegistry
from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
from pixie_tpu_torch.ops import scalar
from pixie_tpu_torch.plan.expressions import ColumnRef, Constant, FuncCall
from pixie_tpu_torch.table.column import StringDictionary
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.builtins import register_all
from pixie_tpu_torch.udf.registry import Registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

F, I, B, T, S = (DataType.FLOAT64, DataType.INT64, DataType.BOOLEAN,
                 DataType.TIME64NS, DataType.STRING)
INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1
N = 4096

REF = RefRegistry()
ref_register_all(REF)
PORT = Registry()
register_all(PORT)

F_EDGES = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e300, -1e300, 2.0**63, -(2.0**63),
           9.2e18, -9.2e18, 2.5, -2.5, 0.5, -0.5, 1.5, 2.3e-308, -7.0, 7.0, 3.0]
I_EDGES = [INT64_MIN, INT64_MAX, -1, 0, 1, -7, 7, 5, -5, INT64_MIN + 1]


def _floats(seed: int, kind: str = "mixed") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "positive":
        v = rng.exponential(3e7, N)
    else:
        v = np.where(rng.random(N) < 0.5, rng.uniform(-30, 30, N), rng.exponential(3e7, N))
    v[: len(F_EDGES)] = F_EDGES
    return v


def _ints(seed: int, small: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = (rng.integers(-50, 50, N) if small else
         rng.integers(INT64_MIN, INT64_MAX, N, dtype=np.int64, endpoint=True))
    v = v.astype(np.int64)
    v[: len(I_EDGES)] = I_EDGES
    return v


def _inputs(t: DataType, seed: int, positive: bool = False, small: bool = False):
    if t == F:
        return _floats(seed, "positive" if positive else "mixed")
    if t == B:
        return np.random.default_rng(seed).random(N) < 0.5
    return _ints(seed, small)


def ulps(a, b) -> np.ndarray:
    """Units in the last place between f64 arrays; 0 where both are NaN or
    equal (infinities included), 2^62 where the signs differ."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    out = np.zeros(a.shape, dtype=np.int64)
    for i in np.flatnonzero(~same):
        x, y = int(a[i:i + 1].view(np.int64)[0]), int(b[i:i + 1].view(np.int64)[0])
        out[i] = abs(x - y) if (x < 0) == (y < 0) and not np.isnan(a[i]) and not np.isnan(b[i]) else 2**62
    return out


def assert_same(got, want, ulp: int = 0, what: str = "") -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind == "f":
        assert got.dtype == np.float64, (what, got.dtype)
        d = ulps(got, want)
        assert int(d.max()) <= ulp, (what, int(d.max()), got[d > ulp][:5], want[d > ulp][:5])
    else:
        assert got.dtype.kind == want.dtype.kind or {got.dtype.kind, want.dtype.kind} <= {"i", "u"}, what
        assert np.array_equal(got, want), (what, got[got != want][:5], want[got != want][:5])


def ref_fn(name: str, types):
    udf = REF.lookup_scalar(name, [RefDT[t.name] for t in types])
    assert udf is not None
    return lambda *a: np.asarray(udf.fn(*[jnp.asarray(x) for x in a]))


def port_routes(name: str, types, args):
    """{route: result} of the port's three routes over ``args``."""
    udf = PORT.lookup_scalar(name, list(types))
    assert udf is not None and udf.arg_types == tuple(types)
    out = {
        "numpy": np.asarray(udf.fn(*args)),
        "torch": udf.fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args]).numpy(),
    }
    cols = [f"c{i}" for i in range(len(args))]
    rel = Relation.of(*[(c, t) for c, t in zip(cols, types)])
    expr = FuncCall(name, tuple(ColumnRef(c) for c in cols))
    ev = ExpressionEvaluator([("out", expr)], rel, PORT)
    env = {c: torch.from_numpy(np.ascontiguousarray(a)) for c, a in zip(cols, args)}
    prog = ev.compile_program([("out", expr, None, None)], {c: v.dtype for c, v in env.items()}, {})
    out["program"] = prog.run(env, {}, N)["out"].numpy()
    return out


TRANSCENDENTAL = {"ln", "log2", "log10", "exp", "pow", "log", "sqrt"}
CASES = [
    ("abs", (F,)), ("abs", (I,)), ("ceil", (F,)), ("floor", (F,)), ("round", (F,)),
    ("ln", (F,)), ("log2", (F,)), ("log10", (F,)), ("exp", (F,)), ("sqrt", (F,)),
    ("pow", (F, F)), ("log", (F, F)), ("modulo", (I, I)), ("modulo", (F, F)),
    ("divide", (I, I)), ("divide", (F, F)), ("negate", (I,)), ("multiply", (I, I)),
    ("bin", (T, I)), ("bin", (I, I)), ("bin", (F, I)),
    ("DurationNanos", (I,)), ("DurationNanos", (F,)), ("DurationNanos", (T,)), ("Time", (I,)),
    ("select", (B, F, F)), ("select", (B, I, I)), ("select", (B, B, B)), ("select", (B, T, T)),
]


@pytest.mark.parametrize("name, types", CASES, ids=[f"{n}{[t.name for t in ts]}" for n, ts in CASES])
def test_scalar_matches_reference(name, types):
    small = name in ("modulo", "bin")  # divisors near 0, -1 and the edges
    args = [_inputs(t, 11 * i + 3, small=small and i > 0) for i, t in enumerate(types)]
    if name == "bin" and types[0] != F:
        args[0] = _ints(5)  # full-range times, negative ones included
    want = ref_fn(name, types)(*args)
    for route, got in port_routes(name, types, args).items():
        assert_same(got, want, 2 if name in TRANSCENDENTAL else 0, f"{name} {route}")


def test_bin_floor_modulo_edges():
    """bin(t, size) = t - t % max(size, 1) with a floor modulo: negative
    times bin down, sizes 0 and -5 act as 1."""
    t = np.array([-7, 7, -10, 0, INT64_MIN, INT64_MAX], np.int64)
    # INT64_MIN % 5 is 2, and INT64_MIN - 2 wraps.
    for size, want in ((5, [-10, 5, -10, 0, INT64_MAX - 1, INT64_MAX - 2]),
                       (0, t.tolist()), (-5, t.tolist())):
        s = np.full(len(t), size, np.int64)
        assert_same(ref_fn("bin", (I, I))(t, s), np.array(want))
        for route, got in port_routes("bin", (I, I), [np.resize(t, N), np.resize(s, N)]).items():
            assert_same(got[: len(t)], np.array(want), 0, route)
    lat = np.array([-7.5, 7.5, -0.0, 0.0, 1.2e8], np.float64)
    size = np.full(len(lat), 50_000_000, np.int64)
    want = ref_fn("bin", (F, I))(lat, size)
    got = port_routes("bin", (F, I), [np.resize(lat, N), np.resize(size, N)])
    for route, g in got.items():
        assert_same(g[: len(lat)], want, 0, route)  # -0.0 bins to -0.0 bit for bit


def test_modulo_and_divide_int64_edges():
    """INT64_MIN % -1 and INT64_MIN / -1 (undefined in C) and a zero divisor:
    modulo gives 0 and divide 0.0 or the f64 quotient, as the reference."""
    a = np.array([INT64_MIN, INT64_MIN, INT64_MIN, 7, -7, 7], np.int64)
    b = np.array([-1, 0, 1, 0, -1, -2], np.int64)
    for name in ("modulo", "divide"):
        want = ref_fn(name, (I, I))(a, b)
        for route, got in port_routes(name, (I, I), [np.resize(a, N), np.resize(b, N)]).items():
            assert_same(got[: len(a)], want, 0, f"{name} {route}")
    assert ref_fn("modulo", (I, I))(a, b).tolist() == [0, 0, 0, 0, 0, -1]


@pytest.mark.parametrize("name", ["floor", "ceil", "round", "DurationNanos"])
def test_fault11_float_to_int64_saturates(name):
    """Fault-11: NaN -> 0, +inf and values >= 2^63 -> INT64_MAX, -inf and
    values <= -2^63 -> INT64_MIN, as JAX converts; numpy's and torch's casts
    give INT64_MIN for all of them."""
    x = np.array([np.nan, np.inf, 1e300, 2.0**63, -np.inf, -1e300, -(2.0**63), 9.2e18, -0.7, 2.5])
    want = ref_fn(name, (F,))(x)
    assert want[:7].tolist() == [0, INT64_MAX, INT64_MAX, INT64_MAX, INT64_MIN, INT64_MIN, INT64_MIN]
    for route, got in port_routes(name, (F,), [np.resize(x, N)]).items():
        assert_same(got[: len(x)], want, 0, route)


def test_fault11_pluck_nan_through_floor_and_duration():
    """service_stats.pxl's DurationNanos(floor(pluck_float64(q, 'p50'))) on
    a missing key: pluck gives NaN, the chain gives 0 on both packages'
    host engines."""
    from pixie_tpu_torch.udf.builtins.math_ops import to_int64

    pluck = PORT.lookup_scalar("pluck_float64", [S, S]).fn
    ref_pluck = REF.lookup_scalar("pluck_float64", [RefDT.STRING, RefDT.STRING]).fn
    q = np.array(['{"p50": 12.7}', '{"p90": 3}', "not json"], dtype=object)
    got = PORT.lookup_scalar("DurationNanos", [F]).fn(
        PORT.lookup_scalar("floor", [F]).fn(pluck(q, "p50")))
    want = ref_fn("DurationNanos", (F,))(ref_fn("floor", (F,))(ref_pluck(q, "p50")))
    assert got.tolist() == want.tolist() == [12, 0, 0]
    assert to_int64(torch.tensor([np.nan])).tolist() == [0]


def test_fault13_subnormals_are_kept():
    """Fault-13: XLA-CPU flushes f64 subnormal inputs to zero in elementwise
    ops (ceil(5e-324) is 0, log(1e-310) is -inf, 5e-324 > 0 is False); the
    port computes on them as IEEE 754, numpy and the card do."""
    x = np.array([5e-324, 1e-310, -1e-310])
    assert ref_fn("ceil", (F,))(x).tolist() == [0, 0, 0]
    assert np.isneginf(ref_fn("ln", (F,))(x)[:2]).all()
    for route, got in port_routes("ceil", (F,), [np.resize(x, N)]).items():
        assert got[:3].tolist() == [1, 1, 0], route
    for route, got in port_routes("ln", (F,), [np.resize(x, N)]).items():
        assert_same(got[:2], np.log(x[:2]), 2, route)


def test_fault12_transcendentals_within_two_ulp():
    """Fault-12 measured: over 2^16 exponential(3e7) and uniform(-30, 30)
    values the port's f64 exp, ln, log2, log10, sqrt, pow and log(b, x) on
    CPU tensors stay within 2 ulp of JAX's."""
    rng = np.random.default_rng(12)
    pos = rng.exponential(3e7, 1 << 16)
    mid = rng.uniform(-30, 30, 1 << 16)
    for name, args in (("exp", [mid]), ("ln", [pos]), ("log2", [pos]), ("log10", [pos]),
                       ("sqrt", [pos]), ("pow", [np.abs(mid), mid]), ("log", [np.abs(mid) + 1.5, pos])):
        types = (F,) * len(args)
        want = ref_fn(name, types)(*args)
        got = PORT.lookup_scalar(name, list(types)).fn(*[torch.from_numpy(a) for a in args])
        assert int(ulps(got.numpy(), want).max()) <= 2, name


def test_program_opcodes_match_the_kernel_source():
    """ops/scalar.py numbers its opcodes and storage kinds, and sizes its
    limits, as scalar_kernels.cu does."""
    src = open(os.path.join(os.path.dirname(scalar.__file__), "kernels",
                            "scalar_kernels.cu")).read()
    ops = re.search(r"enum Op : int \{(.*?)\};", src, re.S).group(1)
    names = [w.split("=")[0].strip() for w in ops.replace("\n", " ").split(",") if w.strip()]
    assert tuple(names) == scalar.OPS
    kinds = re.search(r"enum Kind : int \{(.*?)\};", src, re.S).group(1)
    knames = [w.split("=")[0].strip() for w in kinds.split(",") if w.strip()]
    assert knames == ["K_BOOL", "K_U8", "K_U16", "K_I32", "K_I64", "K_F32", "K_F64"]
    assert list(scalar.KINDS.values()) == list(range(7))
    for name, value in (("kMaxRegs", scalar.MAX_REGS), ("kMaxInstrs", scalar.MAX_INSTRS),
                        ("kMaxConsts", scalar.MAX_CONSTS), ("kMaxCols", scalar.MAX_COLS),
                        ("kMaxLuts", scalar.MAX_LUTS), ("kMaxOuts", scalar.MAX_OUTS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value), name


def test_program_raises_on_what_it_cannot_run():
    """A tree deeper than H17's register file and a host function with no
    table raise ValueError at compile time (the executor's gate then sends
    the fragment to the host graph); a long left-leaning chain needs two
    registers."""
    rel = Relation.of(("s", S), ("x", F))
    deep, chain = ColumnRef("x"), ColumnRef("x")
    for i in range(scalar.MAX_REGS + 8):
        # Right-leaning: every product stays live until the sums close.
        deep = FuncCall("add", (FuncCall("multiply", (ColumnRef("x"), Constant(i + 0.5, F))), deep))
        chain = FuncCall("add", (chain, Constant(i + 0.5, F)))
    host = FuncCall("equal", (FuncCall("toUpper", (ColumnRef("s"),)), Constant("A", S)))
    ev = ExpressionEvaluator([("d", deep), ("c", chain), ("h", host)], rel, PORT)
    dtypes = {"s": torch.int32, "x": torch.float64}
    with pytest.raises(ValueError, match="registers"):
        ev.compile_program([("d", deep, None, None)], dtypes, {})
    prog = ev.compile_program([("c", chain, None, None)], dtypes, {})
    assert max(ins[1] for ins in prog.code if scalar.OPS[ins[0]] != "STORE") < 3
    x = torch.from_numpy(_floats(2))
    want = x.clone()
    for i in range(scalar.MAX_REGS + 8):
        want = want + (i + 0.5)
    assert_same(prog.run({"x": x}, {}, N)["c"].numpy(), want.numpy())
    with pytest.raises(ValueError, match="HOST function"):
        ev.compile_program([("h", host, None, None)], dtypes, {})


# -- the program shapes of service_stats.pxl's queries -------------------------
SERVICES = [f"svc-{i}" for i in range(16)] + [""]
PATHS = ["/healthz", "/readyz", "/api/v1/users/12", "/api/v1/carts/7", "/api/v1/users/9"]
ADDRS = ["10.0.0.1", "10.0.0.2", "-"]


def _http(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": rng.integers(-(10**12), 10**12, n).astype(np.int64),
        "service": rng.integers(0, len(SERVICES), n).astype(np.int32),
        "req_path": rng.integers(0, len(PATHS), n).astype(np.int32),
        "remote_addr": rng.integers(0, len(ADDRS), n).astype(np.int32),
        "resp_status": rng.choice([200, 301, 404, 500], n).astype(np.int64),
        "latency": np.concatenate([[np.nan, np.inf, -0.0, 0.0], rng.exponential(3e7, n - 4)]),
        "resp_body_size": rng.integers(0, 1 << 20, n).astype(np.int64),
    }


REL = [("time_", "TIME64NS"), ("service", "STRING"), ("req_path", "STRING"),
       ("remote_addr", "STRING"), ("resp_status", "INT64"), ("latency", "FLOAT64"),
       ("resp_body_size", "INT64")]


def _tree(pkg: str):
    """{name: tree} of Q1-Q4's non-trivial expressions, built in ``pkg``'s
    expression classes."""
    col, const, call, dt = ((RefCol, RefConst, RefCall, RefDT) if pkg == "ref"
                            else (ColumnRef, Constant, FuncCall, DataType))
    s = lambda v: const(v, dt.STRING)
    pred = call("logical_and", (
        call("logical_and", (
            call("logical_or", (call("notEqual", (col("req_path"), s("/healthz"))),
                                const(False, dt.BOOLEAN))),
            call("logical_or", (call("notEqual", (col("req_path"), s("/readyz"))),
                                const(False, dt.BOOLEAN))),
        )),
        call("logical_or", (call("notEqual", (col("remote_addr"), s("-"))),
                            const(False, dt.BOOLEAN))),
    ))
    return {
        "q1_service": call("notEqual", (col("service"), s(""))),
        "q1_filter": pred,
        "q1_contains": call("contains", (col("service"), s("svc-1"))),
        "q1_failure": call("greaterThanEqual", (col("resp_status"), const(400, dt.INT64))),
        "q1_window": call("bin", (col("time_"), const(10_000_000_000, dt.INT64))),
        "q3_bin": call("DurationNanos", (call("bin", (col("latency"), const(50_000_000, dt.INT64))),)),
        "q4_select": call("select", (call("greaterThanEqual", (col("resp_status"), const(400, dt.INT64))),
                                     col("resp_body_size"), const(0, dt.INT64))),
        "q4_log10": call("log10", (col("latency"),)),
        "q4_floor": call("floor", (call("divide", (col("latency"), const(1e6, dt.FLOAT64))),)),
    }


def _dicts(cls) -> dict:
    out = {}
    for name, values in (("service", SERVICES), ("req_path", PATHS), ("remote_addr", ADDRS)):
        d = cls()
        d.encode(np.asarray(values, dtype=object))
        out[name] = d
    return out


def test_query_programs_match_tree_walk_and_reference():
    """Q1-Q4's trees as one H17 program (the mask with Q1's predicates
    ANDed in, every other tree an output) through the plain interpreter,
    against the torch tree walk and the reference's device_eval: exact,
    log10 within 2 ulp of the reference (Fault-12)."""
    data = _http(N, 6)
    trees, ref_trees = _tree("port"), _tree("ref")
    rel = Relation.of(*[(n, DataType[t]) for n, t in REL])
    ref_rel = RefRelation.of(*[(n, RefDT[t]) for n, t in REL])
    ev = ExpressionEvaluator(list(trees.items()), rel, PORT)
    ref_ev = RefEvaluator(list(ref_trees.items()), ref_rel, REF)
    aux, ref_aux = {}, {}
    for (_, e), (_, re_) in zip(ev.named_exprs, ref_ev.named_exprs):
        aux.update({k: torch.as_tensor(np.asarray(v)) for k, v in ev.build_aux(e, _dicts(StringDictionary)).items()})
        ref_aux.update({k: jnp.asarray(v) for k, v in ref_ev.build_aux(re_, _dicts(RefDict)).items()})
    env = {k: torch.from_numpy(v) for k, v in data.items()}
    env["__valid__"] = torch.from_numpy(np.random.default_rng(1).random(N) < 0.9)
    ref_env = {k: jnp.asarray(v) for k, v in data.items()}
    preds = [trees["q1_service"], trees["q1_filter"], trees["q1_contains"]]
    roots = [(k, e, None, None) for k, e in trees.items() if k not in
             ("q1_service", "q1_filter", "q1_contains")]
    prog = ev.compile_program(roots, {k: v.dtype for k, v in env.items()}, aux,
                              mask=("__valid__", preds))
    assert len(prog.outputs) == len(roots) + 1 and len(prog.luts) == 1
    got = prog.run(env, aux, N)
    walk_mask = env["__valid__"]
    ref_mask = np.asarray(env["__valid__"])
    for p, rp in zip(preds, [ref_trees["q1_service"], ref_trees["q1_filter"], ref_trees["q1_contains"]]):
        walk_mask = walk_mask & ev.device_eval(p, env, aux)
        ref_mask = ref_mask & np.asarray(ref_ev.device_eval(rp, ref_env, ref_aux))
    assert torch.equal(got["__mask__"], walk_mask)
    assert np.array_equal(got["__mask__"].numpy(), ref_mask)
    assert 0 < int(got["__mask__"].sum()) < N
    for name, _, _, _ in roots:
        walk = torch.as_tensor(ev.device_eval(trees[name], env, aux))
        want = np.asarray(ref_ev.device_eval(ref_trees[name], ref_env, ref_aux))
        assert_same(got[name].numpy(), walk.to(got[name].dtype).numpy(), 0, name)
        assert_same(got[name].numpy(), want, 2 if name == "q4_log10" else 0, name)


def _service_stats_programs() -> dict:
    """{name: (program, env, aux)}: service_stats' Q1-Q4 trees as one
    program (the mask with Q1's predicates), svc_let's (Q1's predicates and
    failure: chip_smoke.py's kernel phase program (a)) and the f64 program
    of the kernel phase (b: floor(latency / 1e6), log10, a select)."""
    data = _http(N, 6)
    trees = _tree("port")
    rel = Relation.of(*[(n, DataType[t]) for n, t in REL])
    env = {k: torch.from_numpy(v) for k, v in data.items()}
    env["__valid__"] = torch.from_numpy(np.random.default_rng(1).random(N) < 0.9)
    dtypes = {k: v.dtype for k, v in env.items()}
    preds = [trees["q1_service"], trees["q1_filter"], trees["q1_contains"]]
    shapes = {
        "service_stats": ([k for k in trees if k not in ("q1_service", "q1_filter", "q1_contains")], preds),
        "svc_let": (["q1_failure"], preds),
        "f64": (["q4_floor", "q4_log10", "q4_select"], []),
    }
    out = {}
    for name, (keys, mask) in shapes.items():
        ev = ExpressionEvaluator([(k, trees[k]) for k in keys] + [(f"p{i}", p) for i, p in enumerate(mask)],
                                 rel, PORT)
        aux = {}
        for _, e in ev.named_exprs:
            aux.update({k: torch.as_tensor(np.asarray(v))
                        for k, v in ev.build_aux(e, _dicts(StringDictionary)).items()})
        prog = ev.compile_program([(k, trees[k], None, None) for k in keys], dtypes, aux,
                                  mask=("__valid__", mask))
        out[name] = (prog, env, aux)
    return out


def _kernel_test_programs() -> list:
    """tests/test_torch_kernels.py's H17 programs on the CPU (every opcode,
    column, LUT and output kind; 32 registers)."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_kernels import scalar_programs

    return scalar_programs(torch.device("cpu"), N)


def _peak_live(code) -> int:
    """The most values live at once in allocated ``code``: at each write,
    the registers whose value a later instruction still reads, plus the one
    being written."""
    peak = 0
    for i, ins in enumerate(code):
        if scalar.OPS[ins[0]] == "STORE":
            continue
        live = set()
        for r in range(scalar.MAX_REGS):
            for later in code[i + 1:]:
                if r in [v for _, v in scalar.operand_slots(later)]:
                    live.add(r)
                    break
                if scalar.OPS[later[0]] != "STORE" and later[1] == r:
                    break
        peak = max(peak, len(live | {ins[1]}))
    return peak


def test_program_n_regs_is_the_allocators_high_water_mark():
    """ScalarProgram.n_regs, which sizes H17's register file: at most
    MAX_REGS, one more than the highest register the code names, and the
    most values live at once (the allocator reuses a freed register before
    it takes a new one) for service_stats', svc_let's and the kernel phase's
    programs and the kernel tests' (32 registers among them)."""
    progs = [p for p, _, _ in _service_stats_programs().values()]
    progs += [p for p, _, _ in _kernel_test_programs()]
    assert max(p.n_regs for p in progs) == scalar.MAX_REGS
    for prog in progs:
        named = [ins[1] for ins in prog.code if scalar.OPS[ins[0]] != "STORE"]
        named += [v for ins in prog.code for _, v in scalar.operand_slots(ins)]
        assert prog.n_regs <= scalar.MAX_REGS
        assert prog.n_regs == 1 + max(named) == _peak_live(prog.code)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.to(torch.int64)


_F_OPERANDS = frozenset({
    "ADD_F", "SUB_F", "MUL_F", "DIV_F", "MOD_F", "NEG_F", "ABS_F", "EQ_F", "NE_F", "LT_F",
    "LE_F", "GT_F", "GE_F", "F2I", "FLOOR_F", "CEIL_F", "RINT_F", "LN", "LOG2", "LOG10",
    "EXP", "SQRT", "POW", "LOGB",
})


def run_lowered(prog, cols: list, luts: list, n: int, offsets: list) -> tuple[list, set]:
    """``scalar.lower(prog.code)`` run as H17 runs it, over 8-byte register
    bits: the accumulator, the file (written only by a W_RF row; reading a
    word no row wrote raises), constants from the pool. Returns the
    outputs and the rows whose value was read from the file."""
    acc, rf, read = None, {}, set()
    writer: dict = {}
    outs = [None] * len(prog.outputs)

    def operand(mode: int, idx: int):
        if mode == scalar.M_ACC:
            return acc
        if mode == scalar.M_CONST:
            return torch.full((n,), prog.consts[idx], dtype=torch.int64)
        read.add(writer[idx])
        return rf[idx]

    for r, (op_i, dst, a, b, c, mode, _, _) in enumerate(scalar.lower(prog.code)):
        op = scalar.OPS[op_i]
        assert op != "CONST"
        ops = [operand(mode >> (2 * k) & 3, x) if mode >> (2 * k) & 3 != scalar.M_NONE else None
               for k, x in enumerate((a, b, c))]
        if op == "LOAD":
            val = _bits(scalar._load(cols[a], offsets[a]))
        elif op == "STORE":
            dt = prog.outputs[b][1]
            v = ops[0]
            outs[b] = (v != 0 if dt == torch.bool else v.view(torch.float64) if dt == torch.float64
                       else v.to(dt))
            continue
        elif op == "SELECT":
            val = torch.where(ops[0] != 0, ops[1], ops[2])
        elif op == "LUT":
            lut = luts[b]
            val = _bits(scalar._load(lut[torch.clamp(ops[0], 0, lut.shape[0] - 1)]))
        else:
            typed = [None if v is None else v.view(torch.float64) if op in _F_OPERANDS
                     else v != 0 if op in ("AND", "OR", "NOT") else v for v in ops[:2]]
            fn = scalar._UNARY.get(op) or scalar._BINARY[op]
            val = _bits(fn(typed[0]) if op in scalar.UNARY_OPS else fn(typed[0], typed[1]))
        acc = val.expand(n)
        if mode & scalar.W_RF:
            rf[dst], writer[dst] = acc, r
    return outs, read


def test_lowered_program_equals_the_program():
    """``scalar.lower``, what H17 runs, computes the program's outputs bit
    for bit (the plain interpreter's) for service_stats', svc_let's and the
    kernel phase's programs and the kernel tests' (every opcode, column,
    LUT and output kind; 32 registers), with offsets on every column: no
    CONST is left, an operand read from the file was written there, and
    only values read from the file are written to it."""
    cases = list(_service_stats_programs().values()) + _kernel_test_programs()
    select_c = {row[5] >> 4 & 3 for prog, _, _ in cases for row in scalar.lower(prog.code)
                if scalar.OPS[row[0]] == "SELECT"}
    assert select_c == {scalar.M_RF, scalar.M_ACC, scalar.M_CONST}
    for prog, env, aux in cases:
        cols = [env[c] for c in prog.columns]
        offs = [1000 + 7 * k for k in range(len(cols))]
        luts = [aux[k] for k in prog.luts]
        rows = scalar.lower(prog.code)
        consts = sum(scalar.OPS[ins[0]] == "CONST" for ins in prog.code)
        assert len(rows) == len(prog.code) - consts
        got, read = run_lowered(prog, cols, luts, N, offs)
        want = scalar.eval_plain(prog, cols, luts, N, offs)
        for (name, _), g, w in zip(prog.outputs, got, want):
            assert g.dtype == w.dtype, name
            assert torch.equal(_bits(g), _bits(w)), name
        assert read == {r for r, row in enumerate(rows) if row[5] & scalar.W_RF}


def test_lowered_modes_match_the_kernel_source():
    """ops/scalar.py numbers the operand modes and the write flag as
    scalar_kernels.cu does, and names the ops it runs out of line."""
    src = open(os.path.join(os.path.dirname(scalar.__file__), "kernels",
                            "scalar_kernels.cu")).read()
    modes = re.search(r"enum Mode : int \{(.*?)\};", src, re.S).group(1)
    assert [w.split("=")[0].strip() for w in modes.split(",")] == ["M_RF", "M_ACC", "M_CONST", "M_NONE"]
    assert (scalar.M_RF, scalar.M_ACC, scalar.M_CONST, scalar.M_NONE) == (0, 1, 2, 3)
    assert re.search(r"constexpr int kWriteRf = 1 << (\d+);", src).group(1) == "6"
    assert scalar.W_RF == 1 << 6
    body = re.search(r"u64 long_op\(int op, u64 a, u64 b\) \{(.*?)\n\}", src, re.S).group(1)
    assert set(re.findall(r"case (\w+):", body)) == scalar.LONG_OPS
    group = re.search(r"((?:case \w+: )+)PX_LANES\(long_op", " ".join(src.split())).group(1)
    assert set(re.findall(r"case (\w+):", group)) == scalar.LONG_OPS


def test_lut_gathers_clamp_codes_into_the_table():
    """A LUT gather reads entry clamp(code, 0, len - 1): the key LUT's int32
    gids and the arghash content hashes, as the reference's gathers do."""
    rel = Relation.of(("s", S))
    ev = ExpressionEvaluator([("k", ColumnRef("s"))], rel, PORT)
    codes = torch.tensor([0, 2, -1, 5, 1], dtype=torch.int32)
    aux = {"keylut": torch.tensor([3, 1, 0], dtype=torch.int32),
           "arghash:s": torch.tensor([-5, 2**40, 7], dtype=torch.int64)}
    prog = ev.compile_program(
        [("g", ColumnRef("s"), torch.int32, "keylut"), ("h", ColumnRef("s"), None, "arghash:s")],
        {"s": torch.int32}, aux)
    out = prog.run({"s": codes}, aux, 5)
    assert out["g"].dtype == torch.int32 and out["g"].tolist() == [3, 0, 3, 0, 1]
    assert out["h"].dtype == torch.int64 and out["h"].tolist() == [-5, 7, -5, 7, 2**40]


@pytest.mark.parametrize("lane", ["matmul", "scatter"])
@pytest.mark.parametrize("name", ["variance", "stddev"])
def test_variance_state_matches_reference_and_carries_across(name, lane):
    """variance/stddev over seeded rows in 16 groups against the reference's
    UDA under both of its segment lanes. The port's state: n equal to the
    reference's, sum and sumsq within 1e-12 * sum|terms| of the exact sums
    (H2's bound; math.fsum), and of the reference's plus, under its matmul
    lane, that lane's own error (_F64_CHUNK * 2^-24 * sum|terms|, as
    tests/test_torch_segment.py holds it). Finalized on the same states
    (the reference's, carried in by interop.state_from_numpy), the port is
    within 4e-12 * sumsq / n of the reference. The reference's state after
    one chunk, carried in and updated by the port with a second, finalizes
    within that bound plus the matmul lane's error of both chunks."""
    import math

    from pixie_tpu.ops import segment as ref_segment
    from pixie_tpu_torch import interop

    G = 16
    rng = np.random.default_rng(31)
    chunks = [(rng.exponential(3e7, N), rng.integers(0, G, N).astype(np.int32),
               rng.random(N) < 0.9) for _ in range(2)]
    ref = REF.lookup_uda(name, [RefDT.FLOAT64])
    port = PORT.lookup_uda(name, [F])
    ref_segment.set_strategy(lane)
    try:
        ref_first = ref.update(ref.init(G), *[jnp.asarray(a) for a in (chunks[0][1], chunks[0][0],
                                                                        chunks[0][2])])
        ref_st = ref.update(ref_first, *[jnp.asarray(a) for a in (chunks[1][1], chunks[1][0],
                                                                    chunks[1][2])])
        want = np.asarray(ref.finalize(ref_st))
        want_first = np.asarray(ref.finalize(ref_first))
    finally:
        ref_segment.set_strategy(None)
    lane_err = ref_segment._F64_CHUNK * 2.0**-24 if lane == "matmul" else 0.0
    x = np.concatenate([c[0] for c in chunks])
    g = np.concatenate([c[1] for c in chunks])
    m = np.concatenate([c[2] for c in chunks])
    sel = [m & (g == k) for k in range(G)]
    abs1 = np.array([x[s].sum() for s in sel])
    abs2 = np.array([(x[s] ** 2).sum() for s in sel])
    exact1 = np.array([math.fsum(x[s]) for s in sel])
    exact2 = np.array([math.fsum(x[s] ** 2) for s in sel])
    ref_np = {k: np.asarray(v) for k, v in ref_st.items()}
    ex2 = ref_np["sumsq"] / np.maximum(ref_np["n"], 1)
    power = 2 if name == "stddev" else 1

    st = port.init(G, "cpu")
    for xs, gs, ms in chunks:
        st = port.update(st, torch.from_numpy(gs), torch.from_numpy(xs), torch.from_numpy(ms))
    st = interop.state_to_numpy(port, st)
    assert np.array_equal(st["n"], ref_np["n"])
    assert np.all(np.abs(st["sum"] - exact1) <= 1e-12 * abs1)
    assert np.all(np.abs(st["sumsq"] - exact2) <= 1e-12 * abs2)
    assert np.all(np.abs(st["sum"] - ref_np["sum"]) <= (1e-12 + lane_err) * abs1)
    assert np.all(np.abs(st["sumsq"] - ref_np["sumsq"]) <= (1e-12 + lane_err) * abs2)
    # The same states: the reference's, finalized by both.
    same = port.finalize(interop.state_from_numpy(port, ref_np)).numpy()
    assert np.all(np.abs(same ** power - want ** power) <= 4e-12 * ex2)
    first_np = {k: np.asarray(v) for k, v in ref_first.items()}
    first = port.finalize(interop.state_from_numpy(port, first_np)).numpy()
    ex2_first = first_np["sumsq"] / np.maximum(first_np["n"], 1)
    assert np.all(np.abs(first ** power - want_first ** power) <= 4e-12 * ex2_first)
    # Carried across: the reference's first chunk, the port's second.
    carried = interop.state_from_numpy(port, {k: np.asarray(v) for k, v in ref_first.items()})
    xs, gs, ms = chunks[1]
    carried = port.update(carried, torch.from_numpy(gs), torch.from_numpy(xs),
                          torch.from_numpy(ms))
    out = port.finalize(carried).numpy()
    assert np.all(np.abs(out ** power - want ** power) <= (4e-12 + 3 * lane_err) * ex2)
