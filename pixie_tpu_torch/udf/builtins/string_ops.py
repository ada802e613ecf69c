"""String scalar UDFs (host executor, dictionary-compatible where elementwise).

Counterpart of pixie_tpu/udf/builtins/string_ops.py (ref:
src/carnot/funcs/builtins/string_ops.h). These run on CPU by design (the
reference's planner likewise pins string UDFs to executors via
scalar_udfs_run_on_executor rules) — but because our string columns are
dictionary-encoded, any elementwise string->X function marked
``dict_compatible`` is evaluated once per *distinct* value on the host and
broadcast through the codes on device (a LUT gather of H17), so the per-row
cost is a gather.
"""

from __future__ import annotations

import re

import numpy as np

from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import Registry
from pixie_tpu_torch.udf.udf import Executor, ScalarUDF

S = DataType.STRING
I = DataType.INT64
B = DataType.BOOLEAN
F = DataType.FLOAT64


def _vec(fn, out_dtype=object):
    """Lift an elementwise python fn over numpy object arrays (broadcasting
    scalar args)."""

    def wrapper(*cols):
        n = max((len(c) for c in cols if isinstance(c, np.ndarray)), default=1)
        out = np.empty(n, dtype=out_dtype)
        for i in range(n):
            args = [c[i] if isinstance(c, np.ndarray) else c for c in cols]
            out[i] = fn(*args)
        return out

    return wrapper


def register(r: Registry) -> None:
    def reg(name, args, out, fn, out_dtype=object, dict_compatible=True):
        r.register_scalar(
            ScalarUDF(
                name,
                args,
                out,
                _vec(fn, out_dtype),
                Executor.HOST,
                dict_compatible=dict_compatible,
            )
        )

    reg("contains", (S, S), B, lambda s, sub: sub in s, np.bool_)
    reg("length", (S,), I, len, np.int64)
    reg("find", (S, S), I, lambda s, sub: s.find(sub), np.int64)
    reg(
        "substring",
        (S, I, I),
        S,
        lambda s, start, length: s[int(start): int(start) + int(length)],
    )
    reg("toLower", (S,), S, str.lower)
    reg("toUpper", (S,), S, str.upper)
    reg("trim", (S,), S, str.strip)
    reg("strip", (S,), S, str.strip)
    # string concat: plus on strings (PxL `df.a + df.b`)
    reg("add", (S, S), S, lambda a, b: a + b, dict_compatible=False)
    reg(
        "replace",
        (S, S, S),
        S,
        lambda s, old, new: s.replace(old, new),
    )
    reg("startsWith", (S, S), B, lambda s, p: s.startswith(p), np.bool_)
    reg("endsWith", (S, S), B, lambda s, p: s.endswith(p), np.bool_)

    # regex_match(regex, input) (ref: string_ops.h RegexMatchUDF arg order)
    def regex_match(regex, s):
        try:
            return re.fullmatch(regex, s) is not None
        except re.error:
            return False

    reg("regex_match", (S, S), B, regex_match, np.bool_)
    reg(
        "regex_replace",
        (S, S, S),
        S,
        lambda pattern, s, sub: re.sub(pattern, sub, s),
    )

    # itoa / atoi style conversions
    reg("string", (I,), S, lambda v: str(int(v)))
    reg("string", (F,), S, lambda v: repr(float(v)))
    reg("string", (B,), S, lambda v: "true" if v else "false")
    reg("string", (S,), S, lambda v: v)

    def _atoi(s):
        try:
            return int(s)
        except (ValueError, TypeError):
            return 0

    def _atof(s):
        try:
            return float(s)
        except (ValueError, TypeError):
            return float("nan")

    reg("atoi", (S,), I, _atoi, np.int64)
    reg("atof", (S,), F, _atof, np.float64)

    # script_reference(label, script, k1, v1, k2, v2, ...): flattened by the
    # compiler from the PxL dict literal; emits the UI deeplink JSON the
    # reference produces (ST_SCRIPT_REFERENCE).
    def script_reference(label, script, *kvs):
        import json

        args = {kvs[i]: kvs[i + 1] for i in range(0, len(kvs), 2)}
        return json.dumps(
            {"label": label, "script": script, "args": args}, sort_keys=True
        )

    for n_args in range(0, 5):
        arity = (S, S) + (S,) * (2 * n_args)
        r.register_scalar(
            ScalarUDF(
                "script_reference",
                arity,
                S,
                _vec(script_reference),
                Executor.HOST,
                dict_compatible=False,
            )
        )
