"""Time scalar UDFs: ``bin``, ``DurationNanos`` and ``Time``.

Counterpart of pixie_tpu/udf/builtins/time_ops.py. px.now, px.minutes and
the like are compile-time values of the PxL object layer
(compiler/objects.py), not UDFs. ``bin`` is ``t - t % max(size, 1)`` with
jnp's floor modulo (``math_ops.floor_mod``), so a negative time bins down:
bin(-7, 5) == -10. ``DurationNanos`` of a float truncates toward zero and
saturates as JAX's cast does (Fault-11, ``math_ops.to_int64``).
"""

from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.types import DataType, SemanticType
from pixie_tpu_torch.udf.builtins.math_ops import floor_mod, to_int64
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import Executor, ScalarUDF

I = DataType.INT64
T = DataType.TIME64NS
F = DataType.FLOAT64


def bin_fn(t, size):
    if isinstance(t, torch.Tensor) or isinstance(size, torch.Tensor):
        dev = t.device if isinstance(t, torch.Tensor) else size.device
        size = torch.clamp_min(torch.as_tensor(size, dtype=torch.int64, device=dev), 1)
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            size = size.to(torch.float64)
        return t - floor_mod(t, size)
    size = np.maximum(np.asarray(size, dtype=np.int64), 1)
    t = np.asarray(t)
    if t.dtype.kind == "f":
        size = size.astype(np.float64)
    return t - floor_mod(t, size)


def register(r: Registry) -> None:
    for args, out in [((T, I), T), ((I, I), I), ((F, I), F)]:
        r.register_scalar(
            ScalarUDF(
                "bin", args, out, bin_fn, Executor.DEVICE,
                out_semantic=lambda sems: sems[0] if sems else None,
            )
        )
    # DurationNanos: tag an int64 as a duration (a semantic cast). The F
    # overload truncates (px.DurationNanos(px.floor(...)) in service_stats).
    for arg_t in (I, F, T):
        r.register_scalar(
            ScalarUDF(
                "DurationNanos", (arg_t,), I, to_int64, Executor.DEVICE,
                out_semantic=SemanticType.ST_DURATION_NS,
            )
        )
    # Time: int64 -> TIME64NS cast.
    r.register_scalar(
        ScalarUDF("Time", (I,), T, lambda x: x, Executor.DEVICE,
                  out_semantic=SemanticType.ST_TIME_NS)
    )
