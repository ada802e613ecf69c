"""JSON scalar UDFs, the port's copy of pixie_tpu/udf/builtins/json_ops.py
(ref: src/carnot/funcs/builtins/json_ops.h — PluckUDF,
PluckAsInt64UDF, PluckAsFloat64UDF). Host-executed, dictionary-compatible:
quantile JSON columns have one distinct value per group, so plucks cost one
json parse per group."""

from __future__ import annotations

import json

import numpy as np

from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import Executor, ScalarUDF

S = DataType.STRING
I = DataType.INT64
F = DataType.FLOAT64


def _pluck(default, cast):
    def fn(col, key):
        n = len(col)
        keys = key if isinstance(key, np.ndarray) else None
        out = np.empty(n, dtype=object if cast is str else np.float64)
        if cast is int:
            out = np.empty(n, dtype=np.int64)
        for i in range(n):
            k = keys[i] if keys is not None else key
            try:
                v = json.loads(col[i])[k]
                out[i] = cast(v)
            except (ValueError, KeyError, TypeError):
                out[i] = default
        return out

    return fn


def register(r: Registry) -> None:
    r.register_scalar(
        ScalarUDF("pluck", (S, S), S, _pluck("", str), Executor.HOST,
                  dict_compatible=True)
    )
    r.register_scalar(
        ScalarUDF("pluck_int64", (S, S), I, _pluck(0, int), Executor.HOST,
                  dict_compatible=True)
    )
    r.register_scalar(
        ScalarUDF("pluck_float64", (S, S), F, _pluck(float("nan"), float),
                  Executor.HOST, dict_compatible=True)
    )
