"""Conditional scalar UDFs: ``select`` (pixie_tpu/udf/builtins/
conditionals.py). Numeric select is a DEVICE where that evaluates both
branches; string select runs on the HOST over decoded values, since its
branches need not share a dictionary."""

from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.builtins.math_ops import _is_torch, _tensors
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import Executor, ScalarUDF

S = DataType.STRING
I = DataType.INT64
B = DataType.BOOLEAN
F = DataType.FLOAT64
T = DataType.TIME64NS


def _select(c, a, b):
    if _is_torch(c, a, b):
        # Python floats become f64 tensors first: torch would make an int
        # column and a float constant f32 (Fault-3).
        c, a, b = _tensors(c, a, b)
        return torch.where(c.to(torch.bool), a, b)
    return np.where(c, a, b)


def _select_str(cond, a, b):
    cond = np.asarray(cond, dtype=bool)
    n = len(cond)
    pick = lambda col, i: col[i] if isinstance(col, np.ndarray) else col
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = pick(a, i) if cond[i] else pick(b, i)
    return out


def register(r: Registry) -> None:
    for t in (F, I, B, T):
        r.register_scalar(
            ScalarUDF(
                "select", (B, t, t), t, _select, Executor.DEVICE,
                out_semantic=lambda sems: sems[1] if len(sems) > 1 else None,
            )
        )
    r.register_scalar(ScalarUDF("select", (B, S, S), S, _select_str, Executor.HOST))
