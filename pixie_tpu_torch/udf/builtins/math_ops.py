"""Arithmetic, comparison and math scalar UDFs and the count, sum, mean,
min, max, variance and stddev UDAs.

Counterpart of pixie_tpu/udf/builtins/math_ops.py. Scalars are elementwise
functions that work on numpy arrays (the host exec graph) and on torch
tensors (the device fold's tree walk) alike; on the device the fold compiles
the same trees into one program for the kernel H17 (ops/scalar.py), whose
semantics these functions define. Every float -> int64 conversion saturates
as JAX's does (Fault-11: NaN -> 0, >= 2^63 -> INT64_MAX, <= -2^63 ->
INT64_MIN), which neither numpy's nor torch's cast does. UDA states are
torch tensors with a leading num_groups axis, built on an explicit device;
``update`` reduces through pixie_tpu_torch.ops.segment, whose CUDA kernels
run on the card. Sum-family UDAs feed int64 rows to the fused-sum lane: the
kernel adds int64 directly, so their totals are exact mod 2^64 like the
reference's reconstructed 8-bit limbs. Their f64 kin (sum over FLOAT64,
mean, variance, stddev) feed f64 rows to the moment lane (one H2 launch a
block) and take their counts from the fused lane's presence row.
"""

from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.types import DataType, SemanticType
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import UDA, Executor, MergeKind, ScalarUDF

F = DataType.FLOAT64
I = DataType.INT64
B = DataType.BOOLEAN
S = DataType.STRING
T = DataType.TIME64NS


def _preserve_first(sems):
    return sems[0] if sems else SemanticType.ST_NONE


def _where(cond, a, b):
    """np.where or torch.where, whichever the operands are."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _divide(a, b):
    # divide always returns float (ref: math_ops.h division semantics),
    # with 0 where the divisor is 0.
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a = torch.as_tensor(a).to(torch.float64)
        b = torch.as_tensor(b, device=a.device).to(torch.float64)
    else:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
    return _where(b != 0, a / _where(b == 0, 1.0, b), 0.0)


def _is_torch(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _tensors(*xs):
    """The operands as torch tensors on the first tensor's device; Python
    floats become f64 (torch's default float is f32: Fault-3)."""
    dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, float) or (isinstance(x, np.ndarray) and x.dtype.kind == "f"):
            out.append(torch.as_tensor(x, dtype=torch.float64, device=dev))
        else:
            out.append(torch.as_tensor(x, device=dev))
    return out


def floor_mod(a, b):
    """jnp's ``%``: a floor modulo whose sign follows the divisor. Floats
    take jnp.remainder's form r = fmod(a, b), r += b where r != 0 and its
    sign differs from b's (numpy's ``%`` returns +-0 with b's sign instead,
    and fmod's zero keeps a's); ints take the floor remainder, 0 for a
    divisor of -1 (INT64_MIN % -1 traps in C)."""
    if _is_torch(a, b):
        a, b = _tensors(a, b)
        if a.is_floating_point() or b.is_floating_point():
            a, b = a.to(torch.float64), b.to(torch.float64)
            r = torch.fmod(a, b)
            return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)
        return torch.where(b == -1, 0, torch.remainder(a, torch.where(b == -1, 1, b)))
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        a, b = a.astype(np.float64), b.astype(np.float64)
        with np.errstate(invalid="ignore"):
            r = np.fmod(a, b)
            return np.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)
    return np.where(b == -1, 0, a % np.where(b == -1, 1, b))


def _modulo(a, b):
    if _is_torch(a, b):
        a, b = _tensors(a, b)
        r = floor_mod(a, torch.where(b == 0, torch.ones_like(b), b))
        return torch.where(b != 0, r, torch.zeros_like(r))
    b = np.asarray(b)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = floor_mod(a, np.where(b == 0, 1, b))
    return np.where(b != 0, r, np.zeros_like(r))


INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1


def to_int64(x):
    """Float -> int64 as JAX converts (Fault-11): truncation toward zero,
    NaN -> 0, values >= 2^63 -> INT64_MAX, <= -2^63 -> INT64_MIN. Ints and
    bools pass through as int64."""
    if _is_torch(x):
        (x,) = _tensors(x)
        if not x.is_floating_point():
            return x.to(torch.int64)
        x = x.to(torch.float64)
        hi, lo = x >= 2.0**63, x <= -(2.0**63)
        safe = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
        out = safe.to(torch.int64)
        out = torch.where(hi, torch.full_like(out, INT64_MAX), out)
        return torch.where(lo, torch.full_like(out, INT64_MIN), out)
    x = np.asarray(x)
    if x.dtype.kind != "f":
        return x.astype(np.int64)
    x = x.astype(np.float64)
    hi, lo = x >= 2.0**63, x <= -(2.0**63)
    safe = np.where(hi | lo | np.isnan(x), 0.0, x)
    out = safe.astype(np.int64)
    return np.where(hi, INT64_MAX, np.where(lo, INT64_MIN, out)).astype(np.int64)


def _unary(torch_fn, np_fn):
    """An elementwise f64 function of numpy arrays or torch tensors."""

    def fn(a):
        if _is_torch(a):
            (a,) = _tensors(a)
            return torch_fn(a.to(torch.float64))
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            return np_fn(np.asarray(a, dtype=np.float64))

    return fn


def _abs(a):
    return torch.abs(a) if _is_torch(a) else np.abs(a)


def _pow(a, b):
    if _is_torch(a, b):
        a, b = _tensors(a, b)
        return torch.pow(a.to(torch.float64), b.to(torch.float64))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return np.power(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))


def _log_base(b, x):
    """log(b, x) = ln(x) / ln(b), the reference's two logs and a divide."""
    ln = _unary(torch.log, np.log)
    lx, lb = ln(x), ln(b)
    if _is_torch(lx, lb):
        lx, lb = _tensors(lx, lb)
    else:
        lx, lb = np.asarray(lx), np.asarray(lb)
    with np.errstate(divide="ignore", invalid="ignore"):
        return lx / lb


def register(r: Registry) -> None:
    # -- binary arithmetic -------------------------------------------------
    table = [
        ("add", lambda a, b: a + b, [((F, F), F), ((I, I), I)]),
        ("subtract", lambda a, b: a - b, [((F, F), F), ((I, I), I)]),
        ("multiply", lambda a, b: a * b, [((F, F), F), ((I, I), I)]),
        ("divide", _divide, [((F, F), F), ((I, I), F)]),
        ("modulo", _modulo, [((I, I), I), ((F, F), F)]),
        ("pow", _pow, [((F, F), F)]),
        ("logical_and", lambda a, b: a & b, [((B, B), B)]),
        ("logical_or", lambda a, b: a | b, [((B, B), B)]),
    ]
    for name, fn, sigs in table:
        for args, out in sigs:
            r.register_scalar(
                ScalarUDF(name, args, out, fn, Executor.DEVICE,
                          out_semantic=_preserve_first)
            )

    # -- comparisons (string comparisons resolve via dictionary codes in
    #    the expression evaluator before reaching these) -------------------
    cmps = [
        ("equal", lambda a, b: a == b),
        ("notEqual", lambda a, b: a != b),
        ("lessThan", lambda a, b: a < b),
        ("lessThanEqual", lambda a, b: a <= b),
        ("greaterThan", lambda a, b: a > b),
        ("greaterThanEqual", lambda a, b: a >= b),
    ]
    for name, fn in cmps:
        for args in [(F, F), (I, I), (B, B), (T, T)]:
            r.register_scalar(ScalarUDF(name, args, B, fn, Executor.DEVICE))
    for name, fn in cmps[:2]:
        r.register_scalar(ScalarUDF(name, (S, S), B, fn, Executor.DEVICE))

    # -- unary -------------------------------------------------------------
    unary = [
        ("negate", lambda a: -a, [(F, F), (I, I)]),
        ("logical_not", lambda a: ~a, [(B, B)]),
        ("abs", _abs, [(F, F), (I, I)]),
        ("ceil", lambda a: to_int64(_unary(torch.ceil, np.ceil)(a)), [(F, I)]),
        ("floor", lambda a: to_int64(_unary(torch.floor, np.floor)(a)), [(F, I)]),
        # Round half to even, as jnp.round, torch.round and np.round do.
        ("round", lambda a: to_int64(_unary(torch.round, np.round)(a)), [(F, I)]),
        ("ln", _unary(torch.log, np.log), [(F, F)]),
        ("log2", _unary(torch.log2, np.log2), [(F, F)]),
        ("log10", _unary(torch.log10, np.log10), [(F, F)]),
        ("exp", _unary(torch.exp, np.exp), [(F, F)]),
        ("sqrt", _unary(torch.sqrt, np.sqrt), [(F, F)]),
    ]
    for name, fn, sigs in unary:
        for arg, out in sigs:
            r.register_scalar(
                ScalarUDF(name, (arg,), out, fn, Executor.DEVICE,
                          out_semantic=_preserve_first)
            )
    r.register_scalar(ScalarUDF("log", (F, F), F, _log_base, Executor.DEVICE))

    # -- UDAs: init(num_groups, device) -> state ---------------------------
    def count_uda(arg_t):
        return UDA(
            name="count",
            arg_types=(arg_t,),
            out_type=I,
            init=lambda g, device: torch.zeros(g, dtype=torch.int64, device=device),
            update=lambda st, gids, col, mask=None: st
            + segment.seg_count(gids, st.shape[0], mask),
            merge=lambda a, b: a + b,
            finalize=lambda st: st,
            merge_kind=MergeKind.PSUM,
            reads_args=False,  # counts rows; never reads the column
            fused_rows=lambda col, mask: [segment.PRESENCE],
            fused_apply=lambda st, t: st + t[0],
            doc="Number of rows in the group.",
        )

    for t in (F, I, S, B, T):
        r.register_uda(count_uda(t))

    def sum_uda(arg_t, out_t, acc_dtype):
        moment_rows = moment_apply = None
        if acc_dtype == torch.int64:
            # Masked rows are skipped by the reduction itself; H1 reads a
            # narrow or bool column as it lies.
            fused_rows = lambda col, mask: [col]
            fused_apply = lambda st, t: st + t[0]
        else:
            fused_rows = fused_apply = None  # f64 takes the moment lane (H2)
            moment_rows = lambda col, mask: [segment.F64Row(col)]
            moment_apply = lambda st, t, n: st + t[0]
        narrow = acc_dtype == torch.int64
        return UDA(
            name="sum",
            arg_types=(arg_t,),
            out_type=out_t,
            init=lambda g, device: torch.zeros(g, dtype=acc_dtype, device=device),
            update=lambda st, gids, col, mask=None: st
            + segment.seg_sum(segment.widen(col).to(acc_dtype), gids, st.shape[0], mask),
            merge=lambda a, b: a + b,
            finalize=lambda st: st,
            merge_kind=MergeKind.PSUM,
            out_semantic=_preserve_first,
            fused_rows=fused_rows,
            fused_apply=fused_apply,
            moment_rows=moment_rows,
            moment_apply=moment_apply,
            narrow_args=narrow,
            doc="Sum of the column within the group.",
        )

    r.register_uda(sum_uda(F, F, torch.float64))
    r.register_uda(sum_uda(I, I, torch.int64))
    r.register_uda(sum_uda(B, I, torch.int64))

    def mean_rows(col, mask):
        # The bool predicate of mean(x >= c) sums as an integer row in H1's
        # launch: a block's count of trues lies below 2^53, so its f64 value
        # is the reference's f64 sum of the 0/1 values bit for bit.
        return [col] if col.dtype == torch.bool else [segment.F64Row(col)]

    def mean_apply(st, t, n):
        return {"sum": st["sum"] + t[0].to(torch.float64), "count": st["count"] + n}

    def mean_update(st, gids, col, mask=None):
        G = st["count"].shape[0]
        if col.dtype == torch.bool:  # one H1 launch: the trues, then the count
            t = segment.fused_segment_sums([col], gids, G, mask)
            return mean_apply(st, [t[0]], t[1])
        return mean_apply(st, [segment.seg_sum(col.to(torch.float64), gids, G, mask)],
                          segment.seg_count(gids, G, mask))

    def mean_uda(arg_t):
        return UDA(
            name="mean",
            arg_types=(arg_t,),
            out_type=F,
            init=lambda g, device: {
                "sum": torch.zeros(g, dtype=torch.float64, device=device),
                "count": torch.zeros(g, dtype=torch.int64, device=device),
            },
            update=mean_update,
            merge=lambda a, b: {
                "sum": a["sum"] + b["sum"],
                "count": a["count"] + b["count"],
            },
            finalize=lambda st: st["sum"] / torch.clamp_min(st["count"], 1),
            merge_kind=MergeKind.PSUM,
            out_semantic=_preserve_first,
            moment_rows=mean_rows,
            moment_apply=mean_apply,
            doc="Arithmetic mean (sum/count pair state; merge-safe).",
        )

    r.register_uda(mean_uda(F))

    def minmax_uda(name, arg_t, is_min):
        # The reference's init, update, merge and finalize
        # (pixie_tpu/udf/builtins/math_ops.py:183-219): update is
        # pick(state, seg_fn(col)), which H11 computes in place on the state,
        # reading an INT64 column the fold narrowed as staged.
        dtype = torch.float64 if arg_t == F else torch.int64
        ident = segment._identity_for(dtype, is_min)

        def fin(st):
            return torch.where(st == ident, torch.zeros_like(st), st)

        return UDA(
            name=name,
            arg_types=(arg_t,),
            out_type=arg_t,
            init=lambda g, device: torch.full((g,), ident, dtype=dtype, device=device),
            update=lambda st, gids, col, mask=None: segment.segment_minmax(
                st, col, gids, mask, is_min
            ),
            merge=lambda a, b: segment.minmax_pick(a, b, is_min),
            finalize=fin,
            merge_kind=MergeKind.PMIN if is_min else MergeKind.PMAX,
            out_semantic=_preserve_first,
            narrow_args=dtype == torch.int64,
            doc=f"{'Minimum' if is_min else 'Maximum'} value in the group.",
        )

    for arg_t in (F, I):
        r.register_uda(minmax_uda("min", arg_t, True))
        r.register_uda(minmax_uda("max", arg_t, False))

    def var_rows(col, mask):
        # The column and its squares, each square rounded on its own before
        # the add, as the reference sums col * col (math_ops.py:237).
        return [segment.F64Row(col), segment.F64Row(col, square=True)]

    def var_apply(st, t, n):
        return {"n": st["n"] + n, "sum": st["sum"] + t[0], "sumsq": st["sumsq"] + t[1]}

    def var_update(st, gids, col, mask=None):
        G = st["n"].shape[0]
        sums = segment.f64_segment_sums(var_rows(col, mask), gids, G, mask)
        return var_apply(st, [sums[0], sums[1]], segment.seg_count(gids, G, mask))

    def var_state_uda(name, finalize):
        # State n, sum, sumsq (pixie_tpu/udf/builtins/math_ops.py:222-251):
        # n the count (H1), the sums one H2 launch of two rows.
        return UDA(
            name=name,
            arg_types=(F,),
            out_type=F,
            init=lambda g, device: {
                "n": torch.zeros(g, dtype=torch.int64, device=device),
                "sum": torch.zeros(g, dtype=torch.float64, device=device),
                "sumsq": torch.zeros(g, dtype=torch.float64, device=device),
            },
            update=var_update,
            merge=lambda a, b: {k: a[k] + b[k] for k in a},
            finalize=finalize,
            merge_kind=MergeKind.PSUM,
            moment_rows=var_rows,
            moment_apply=var_apply,
            doc="Moment-based dispersion aggregate.",
        )

    def _var(st):
        n = torch.clamp_min(st["n"].to(torch.float64), 1.0)
        v = st["sumsq"] / n - (st["sum"] / n) ** 2
        return torch.clamp_min(v, 0.0)

    r.register_uda(var_state_uda("variance", _var))
    r.register_uda(var_state_uda("stddev", lambda st: torch.sqrt(_var(st))))
