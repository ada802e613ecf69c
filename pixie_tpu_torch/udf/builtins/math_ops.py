"""Arithmetic/comparison scalar UDFs and the count, sum, mean, min and max
UDAs.

Counterpart of pixie_tpu/udf/builtins/math_ops.py for the subset the port
runs. Scalars are elementwise functions that work on numpy arrays (the host
exec graph) and on torch tensors (the device fold) alike. UDA states are
torch tensors with a leading num_groups axis, built on an explicit device;
``update`` reduces through pixie_tpu_torch.ops.segment, whose CUDA kernels
run on the card. Sum-family UDAs feed int64 rows to the fused-sum lane: the
kernel adds int64 directly, so their totals are exact mod 2^64 like the
reference's reconstructed 8-bit limbs.
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


def _modulo(a, b):
    return _where(b != 0, a % _where(b == 0, 1, b), 0)


def register(r: Registry) -> None:
    # -- binary arithmetic -------------------------------------------------
    table = [
        ("add", lambda a, b: a + b, [((F, F), F), ((I, I), I)]),
        ("subtract", lambda a, b: a - b, [((F, F), F), ((I, I), I)]),
        ("multiply", lambda a, b: a * b, [((F, F), F), ((I, I), I)]),
        ("divide", _divide, [((F, F), F), ((I, I), F)]),
        ("modulo", _modulo, [((I, I), I), ((F, F), F)]),
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
    ]
    for name, fn, sigs in unary:
        for arg, out in sigs:
            r.register_scalar(
                ScalarUDF(name, (arg,), out, fn, Executor.DEVICE,
                          out_semantic=_preserve_first)
            )

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
            fused_rows=lambda col, mask: [mask.to(torch.int64)],
            fused_apply=lambda st, t: st + t[0],
            doc="Number of rows in the group.",
        )

    for t in (F, I, S, B, T):
        r.register_uda(count_uda(t))

    def sum_uda(arg_t, out_t, acc_dtype):
        if acc_dtype == torch.int64:
            # Masked rows are skipped by the reduction itself.
            fused_rows = lambda col, mask: [col.to(torch.int64)]
            fused_apply = lambda st, t: st + t[0]
        else:
            fused_rows = fused_apply = None  # f64 keeps its own lane
        return UDA(
            name="sum",
            arg_types=(arg_t,),
            out_type=out_t,
            init=lambda g, device: torch.zeros(g, dtype=acc_dtype, device=device),
            update=lambda st, gids, col, mask=None: st
            + segment.seg_sum(col.to(acc_dtype), gids, st.shape[0], mask),
            merge=lambda a, b: a + b,
            finalize=lambda st: st,
            merge_kind=MergeKind.PSUM,
            out_semantic=_preserve_first,
            fused_rows=fused_rows,
            fused_apply=fused_apply,
            doc="Sum of the column within the group.",
        )

    r.register_uda(sum_uda(F, F, torch.float64))
    r.register_uda(sum_uda(I, I, torch.int64))
    r.register_uda(sum_uda(B, I, torch.int64))

    def mean_uda(arg_t):
        return UDA(
            name="mean",
            arg_types=(arg_t,),
            out_type=F,
            init=lambda g, device: {
                "sum": torch.zeros(g, dtype=torch.float64, device=device),
                "count": torch.zeros(g, dtype=torch.int64, device=device),
            },
            update=lambda st, gids, col, mask=None: {
                # The bool predicate of mean(x >= c) is read as f64 here,
                # explicitly: torch's default float is f32.
                "sum": st["sum"]
                + segment.seg_sum(
                    col.to(torch.float64), gids, st["sum"].shape[0], mask
                ),
                "count": st["count"]
                + segment.seg_count(gids, st["count"].shape[0], mask),
            },
            merge=lambda a, b: {
                "sum": a["sum"] + b["sum"],
                "count": a["count"] + b["count"],
            },
            finalize=lambda st: st["sum"] / torch.clamp_min(st["count"], 1),
            merge_kind=MergeKind.PSUM,
            out_semantic=_preserve_first,
            doc="Arithmetic mean (sum/count pair state; merge-safe).",
        )

    r.register_uda(mean_uda(F))

    def minmax_uda(name, arg_t, is_min):
        # The reference's init, update, merge and finalize
        # (pixie_tpu/udf/builtins/math_ops.py:183-219): update is
        # pick(state, seg_fn(col)), which H11 computes in place on the state.
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
                st, col.to(dtype), gids, mask, is_min
            ),
            merge=lambda a, b: segment.minmax_pick(a, b, is_min),
            finalize=fin,
            merge_kind=MergeKind.PMIN if is_min else MergeKind.PMAX,
            out_semantic=_preserve_first,
            doc=f"{'Minimum' if is_min else 'Maximum'} value in the group.",
        )

    for arg_t in (F, I):
        r.register_uda(minmax_uda("min", arg_t, True))
        r.register_uda(minmax_uda("max", arg_t, False))
