"""Scalar expression evaluation over RowBatches.

Ref: src/carnot/exec/expression_evaluator.{h,cc} — the reference has two
strategies (vector-native over ColumnWrapper vectors, arrow-native over
arrays). Ours also has two, split along the TPU boundary:

- **host path** (``evaluate``): eager evaluation with numpy over a
  RowBatch; HOST-executor UDFs (strings/JSON/metadata) run here. String
  columns stay dictionary-encoded; ``dict_compatible`` host funcs run on the
  dictionary's (tiny) unique values and the result is gathered through the
  codes — the row-count work never touches Python strings.
- **device path** (``compile_program``): the trees a block needs compile
  into one register program (ops/scalar.py) that the kernel H17 runs per
  block on the card, and its plain interpreter on the CPU (the counterpart
  of the reference's jnp device_eval, pixie_tpu/exec/
  expression_evaluator.py:219, which XLA fuses into the fold). String
  semantics are code-space; host-func subtrees must have been precomputed
  into lookup tables by ``build_aux`` (host side, per staging) and moved to
  the device by the caller. ``device_eval``, the same trees as one torch op
  per node, stays as a second reference for the tests.

String comparisons lower to int32 code comparisons (the write-side dictionary
encode in table/column.py guarantees code comparability within a table).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from pixie_tpu_torch.ops import scalar
from pixie_tpu_torch.plan.expressions import (
    ColumnRef,
    Constant,
    FuncCall,
    ScalarExpression,
    expr_data_type,
)
from pixie_tpu_torch.device import resolve_device
from pixie_tpu_torch.table.column import DictColumn, StringDictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.types.dtypes import host_dtype
from pixie_tpu_torch.udf.udf import Executor


def call_host(udf, fn_args: list, func_ctx=None, device=None):
    """A HOST function over ``fn_args``, with the function context first
    (``needs_ctx``) and the engine's device (``needs_device``)."""
    if udf.needs_ctx:
        fn_args = [func_ctx] + list(fn_args)
    if udf.needs_device:
        return udf.fn(*fn_args, device=resolve_device(device))
    return udf.fn(*fn_args)


class ExpressionEvaluator:
    """Evaluates named expressions (a Map's output list) or one predicate."""

    def __init__(
        self,
        named_exprs: list[tuple[str, ScalarExpression]],
        input_relation: Relation,
        registry,
        func_ctx=None,
        device=None,
    ):
        self.named_exprs = list(named_exprs)
        self.input_relation = input_relation
        self.registry = registry
        self.func_ctx = func_ctx
        # The engine's device (None: the card), handed to the HOST functions
        # that ask for it (``needs_device``): resolved at the call.
        self.device = device
        self._resolved: dict[int, Any] = {}
        for _, e in self.named_exprs:
            self._resolve(e)
        # Compiled H17 programs, by (roots, mask, env dtypes, aux).
        self._programs: dict = {}

    def _resolve(self, expr) -> None:
        """Pre-resolve UDF lookups for every FuncCall in the tree."""
        if isinstance(expr, FuncCall):
            for a in expr.args:
                self._resolve(a)
            arg_types = [
                expr_data_type(a, self.input_relation, self.registry)
                for a in expr.args
            ]
            udf = self.registry.lookup_scalar(expr.name, arg_types)
            if udf is None:
                raise ValueError(
                    f"no scalar function {expr.name}"
                    f"({', '.join(t.name for t in arg_types)})"
                )
            self._resolved[id(expr)] = (udf, arg_types)

    # ------------------------------------------------------------------ host
    def evaluate(self, batch: RowBatch, output_relation: Relation) -> RowBatch:
        env = {
            schema.name: col
            for schema, col in zip(batch.relation, batch.columns)
        }
        out_cols = []
        for (name, e), schema in zip(self.named_exprs, output_relation):
            v = self._eval(e, env, batch.num_rows)
            out_cols.append(self._to_column(v, schema.data_type, batch.num_rows))
        return RowBatch(output_relation, out_cols, eow=batch.eow, eos=batch.eos)

    def evaluate_predicate(self, batch: RowBatch) -> np.ndarray:
        assert len(self.named_exprs) == 1
        v = self._eval(self.named_exprs[0][1], dict(
            zip(batch.relation.col_names(), batch.columns)
        ), batch.num_rows)
        return np.asarray(v, dtype=bool)

    def _to_column(self, v, data_type: DataType, num_rows: int):
        if isinstance(v, DictColumn):
            if len(v) == 1 and num_rows != 1:
                # Zero-arg funcs (px._exec_hostname) produce one value for
                # the whole batch: broadcast the code, keep the dictionary.
                return DictColumn(
                    np.broadcast_to(v.codes, (num_rows,)).copy(), v.dictionary
                )
            return v
        if data_type == DataType.STRING:
            if np.ndim(v) == 0:
                v = np.full(num_rows, v, dtype=object)
            d = StringDictionary()
            return DictColumn(d.encode(np.asarray(v, dtype=object)), d)
        arr = np.asarray(v, dtype=host_dtype(data_type))
        if arr.ndim == 0:
            arr = np.full(num_rows, arr, dtype=host_dtype(data_type))
        elif arr.shape == (1,) and num_rows != 1:
            arr = np.broadcast_to(arr, (num_rows,)).copy()
        return arr

    def _eval(self, expr, env: dict, num_rows: int):
        if isinstance(expr, ColumnRef):
            return env[expr.name]
        if isinstance(expr, Constant):
            return expr.value
        assert isinstance(expr, FuncCall), expr
        udf, arg_types = self._resolved[id(expr)]
        args = [self._eval(a, env, num_rows) for a in expr.args]
        if any(t == DataType.STRING for t in arg_types):
            out = self._eval_string_func(udf, arg_types, args, expr)
        else:
            fn_args = list(args) + list(expr.init_args)
            if udf.needs_ctx:
                out = udf.fn(self.func_ctx, *fn_args)
            elif udf.executor == Executor.HOST:
                out = np.asarray(call_host(udf, fn_args, self.func_ctx, self.device))
            else:
                out = udf.fn(*fn_args)
        # String-producing funcs must hand a DictColumn to their consumer —
        # a parent device comparison would otherwise compare Python objects
        # against int32 codes.
        if udf.out_type == DataType.STRING and not isinstance(
            out, (DictColumn, str)
        ):
            arr = np.asarray(out, dtype=object)
            if arr.ndim == 0:
                return str(arr)
            d = StringDictionary()
            out = DictColumn(d.encode(arr), d)
        return out

    def _eval_string_func(self, udf, arg_types, args, expr):
        """String-typed arguments: code-space compare for DEVICE funcs,
        dictionary-value application for dict_compatible HOST funcs, decoded
        application otherwise."""
        if udf.executor == Executor.DEVICE:
            # Code-space semantics (equal/notEqual). Align every string arg
            # into one dictionary's code space.
            base: Optional[StringDictionary] = None
            for a, t in zip(args, arg_types):
                if t == DataType.STRING and isinstance(a, DictColumn):
                    base = a.dictionary
                    break
            if base is None:
                # All string args are plain Python strings (const-vs-const):
                # compare the values directly, not sentinel codes.
                return udf.fn(*args, *expr.init_args)
            mapped = []
            for a, t in zip(args, arg_types):
                if t != DataType.STRING:
                    mapped.append(a)
                elif isinstance(a, DictColumn):
                    if a.dictionary is not base:
                        mapped.append(base.encode(a.decode()))
                    else:
                        mapped.append(a.codes)
                elif isinstance(a, str):
                    # Unseen constants get -1, which equals nothing.
                    mapped.append(np.int32(base.lookup(a)))
                else:
                    mapped.append(a)
            return udf.fn(*mapped, *expr.init_args)

        # HOST executor. The dictionary fast path pairs per-value results
        # back through ONE codes array, so it requires exactly one
        # DictColumn argument (two distinct columns sharing a dictionary
        # still differ per-row) and every other argument to be a scalar —
        # a per-row array arg would be misaligned with per-unique values.
        dict_args = [a for a in args if isinstance(a, DictColumn)]
        others_scalar = all(
            isinstance(a, DictColumn) or np.ndim(a) == 0 for a in args
        )
        if udf.dict_compatible and len(dict_args) == 1 and others_scalar:
            d = dict_args[0].dictionary
            values = np.asarray(d.values(), dtype=object)
            fn_args = [
                (values if isinstance(a, DictColumn) else a) for a in args
            ] + list(expr.init_args)
            per_value = np.asarray(call_host(udf, fn_args, self.func_ctx, self.device))
            codes = dict_args[0].codes
            if udf.out_type == DataType.STRING:
                out_dict = StringDictionary()
                mapped = out_dict.encode(per_value.astype(object))
                # Negative codes (missing) map to "".
                empty = out_dict.get_code("")
                out_codes = np.where(codes >= 0, mapped[np.maximum(codes, 0)], empty)
                return DictColumn(out_codes.astype(np.int32), out_dict)
            safe = np.maximum(codes, 0)
            out = per_value[safe]
            if (codes < 0).any():
                out = np.where(codes < 0, np.zeros_like(out), out)
            return out
        # Fallback: decode and run row-wise over full columns.
        fn_args = [
            (a.decode() if isinstance(a, DictColumn) else a) for a in args
        ] + list(expr.init_args)
        return np.asarray(call_host(udf, fn_args, self.func_ctx, self.device))

    # ---------------------------------------------------------------- device
    def device_eval(self, expr, env: dict, aux: dict):
        """Elementwise torch evaluation, one op per node: the tree walk the
        tests hold H17's compiled program against (the device lanes run
        ``compile_program``'s program instead).

        ``env`` maps column name → tensor (string columns as int codes);
        ``aux`` maps aux keys from ``build_aux`` → tensors on the same
        device (constant codes as 0-d tensors, dict-func lookup tables as
        1-d tensors).
        """
        if isinstance(expr, ColumnRef):
            return env[expr.name]
        if isinstance(expr, Constant):
            if expr.data_type == DataType.STRING:
                return aux[f"const:{id(expr)}"]
            if expr.data_type == DataType.FLOAT64:
                # A 0-d f64 tensor, not a Python float: torch would promote
                # an int column and a Python float to its default f32.
                return torch.tensor(expr.value, dtype=torch.float64)
            return expr.value
        udf, arg_types = self._resolved[id(expr)]
        lut_key = f"lut:{id(expr)}"
        if lut_key in aux:
            # Precomputed dictionary-value table; gather through codes.
            # Only the string COLUMN feeds the gather; string constants
            # (e.g. a pluck key) are already baked into the table.
            (arg,) = [
                self.device_eval(a, env, aux)
                for a, t in zip(expr.args, arg_types)
                if t == DataType.STRING and isinstance(a, ColumnRef)
            ]
            return aux[lut_key][torch.clamp_min(arg, 0).to(torch.int64)]
        if udf.executor != Executor.DEVICE:
            raise ValueError(
                f"{udf.name} is a HOST function with no precomputed table; "
                "cannot trace on device"
            )
        args = [self.device_eval(a, env, aux) for a in expr.args]
        return udf.fn(*args, *expr.init_args)

    def compile_program(
        self, roots, env_dtypes: dict, aux: dict, mask=None
    ) -> scalar.ScalarProgram:
        """The H17 program of one block's trees, compiled once per key.

        ``roots``: [(result name, expr, torch dtype or None (the expr's
        own), aux key of a LUT to gather the result through or None)].
        ``mask``: (env name of the block's validity mask, [predicates]): the
        result ``"__mask__"`` is the mask ANDed with every predicate.
        ``env_dtypes`` maps each env column to its dtype; ``aux`` holds the
        string-constant codes (baked into the program) and the LUTs (read
        per launch). Raises ValueError on a tree the kernel cannot run (a
        host function without a table, an unknown function, a tree deeper
        than the register file)."""
        consts = tuple(
            (k, int(v)) for k, v in sorted(aux.items()) if k.startswith("const:")
        )
        key = (
            tuple((n, id(e), dt, lut) for n, e, dt, lut in roots),
            None if mask is None else (mask[0], tuple(id(p) for p in mask[1])),
            tuple(sorted((k, str(v)) for k, v in env_dtypes.items())),
            consts,
            tuple(sorted((k, str(v.dtype)) for k, v in aux.items() if not k.startswith("const:"))),
        )
        hit = self._programs.get(key)
        if hit is None:
            prog = _ProgramCompiler(self, env_dtypes, aux).compile(roots, mask)
            # The entry keeps its trees alive, so their ids in the key
            # cannot be reused by other trees.
            hit = self._programs[key] = (roots, mask, prog)
        return hit[2]

    def build_aux(self, expr, dictionaries: dict[str, StringDictionary]) -> dict:
        """Host-side precomputation making ``expr`` device-traceable:
        string constants → their int32 code; dict_compatible host-func
        subtrees over a single string column → per-dictionary-value LUTs."""
        aux: dict[str, np.ndarray] = {}
        self._collect_aux(expr, dictionaries, aux)
        return aux

    def _collect_aux(self, expr, dictionaries, aux) -> None:
        if isinstance(expr, Constant):
            if expr.data_type == DataType.STRING:
                # Resolve against the single dictionary in scope; the caller
                # maps which column's dictionary applies via _const_dict.
                d = self._const_dict(expr, dictionaries)
                aux[f"const:{id(expr)}"] = np.int32(
                    d.lookup(expr.value) if d is not None else -1
                )
            return
        if not isinstance(expr, FuncCall):
            return
        udf, arg_types = self._resolved[id(expr)]
        str_cols = [
            a for a, t in zip(expr.args, arg_types)
            if t == DataType.STRING and isinstance(a, ColumnRef)
        ]
        if (
            udf.executor == Executor.HOST
            and udf.dict_compatible
            and len(str_cols) == 1
            and all(
                # Non-string args must be compile-time constants; a per-row
                # column could not align with per-dictionary-value results.
                isinstance(a, Constant)
                or (isinstance(a, ColumnRef) and t == DataType.STRING)
                for a, t in zip(expr.args, arg_types)
            )
        ):
            d = dictionaries.get(str_cols[0].name)
            if d is not None:
                values = np.asarray(d.values(), dtype=object)
                fn_args = [
                    values if (t == DataType.STRING and isinstance(a, ColumnRef))
                    else (a.value if isinstance(a, Constant) else None)
                    for a, t in zip(expr.args, arg_types)
                ] + list(expr.init_args)
                out = np.asarray(call_host(udf, fn_args, self.func_ctx, self.device))
                if udf.out_type == DataType.STRING:
                    raise ValueError(
                        "string-producing host funcs need a Map before the "
                        "device pipeline (reference precedent: "
                        "scalar_udfs_run_on_executor placement rules)"
                    )
                aux[f"lut:{id(expr)}"] = out
                return
        for a in expr.args:
            self._collect_aux(a, dictionaries, aux)

    def _const_dict(self, const, dictionaries):
        """Find which column's dictionary a string constant compares against
        (the sibling string ColumnRef in its parent FuncCall)."""
        for _, root in self.named_exprs:
            parent = _find_parent(root, const)
            if parent is None:
                continue
            for a in parent.args:
                if isinstance(a, ColumnRef) and a.name in dictionaries:
                    return dictionaries[a.name]
        return None


def _kind_of(t: DataType) -> int:
    if t == DataType.FLOAT64:
        return scalar.F
    if t == DataType.BOOLEAN:
        return scalar.B
    if t in (DataType.INT64, DataType.TIME64NS, DataType.STRING):
        return scalar.I  # strings compare as their int32 codes
    raise ValueError(f"H17 has no {t.name} registers")


_ARITH = {"add": "ADD", "subtract": "SUB", "multiply": "MUL"}
_CMPS = {
    "equal": "EQ", "notEqual": "NE", "lessThan": "LT",
    "lessThanEqual": "LE", "greaterThan": "GT", "greaterThanEqual": "GE",
}
_F_UNARY = {"ln": "LN", "log2": "LOG2", "log10": "LOG10", "exp": "EXP", "sqrt": "SQRT"}
_TO_INT = {"floor": "FLOOR_F", "ceil": "CEIL_F", "round": "RINT_F"}


class _ProgramCompiler:
    """Expression trees -> one H17 program: virtual registers in emission
    order (each column loaded once, a shared subtree emitted once), the
    reference's dtype semantics as explicit casts, then registers assigned
    by last use into the kernel's register file."""

    def __init__(self, ev: ExpressionEvaluator, env_dtypes: dict, aux: dict):
        self.ev, self.env_dtypes, self.aux = ev, env_dtypes, aux
        self.code: list = []  # [op, dst, a, b, c] over virtual registers
        self.kinds: list = []
        self.columns: list = []
        self.consts: list = []
        self.luts: list = []
        self.outputs: list = []
        self.memo: dict = {}

    def emit(self, op: str, kind: int, a: int = 0, b: int = 0, c: int = 0) -> int:
        self.kinds.append(kind)
        v = len(self.kinds) - 1
        self.code.append([scalar.OP[op], v, a, b, c])
        return v

    def const(self, value, kind: int) -> int:
        if kind == scalar.F:
            bits = int(torch.tensor([float(value)], dtype=torch.float64).view(torch.int64)[0])
        else:
            bits = int(bool(value)) if kind == scalar.B else int(value)
        memo = ("const", bits, kind)
        if memo not in self.memo:
            if bits not in self.consts:
                self.consts.append(bits)
            self.memo[memo] = self.emit("CONST", kind, self.consts.index(bits), kind)
        return self.memo[memo]

    def coerce(self, v: int, want: int) -> int:
        have = self.kinds[v]
        if have == want:
            return v
        if want == scalar.F:
            return self.emit("I2F", scalar.F, v)
        if want == scalar.I and have == scalar.B:
            return self.emit("B2I", scalar.I, v)
        raise ValueError(f"H17 has no implicit cast from kind {have} to {want}")

    def lut(self, v: int, key: str) -> int:
        if key not in self.luts:
            self.luts.append(key)
        return self.emit("LUT", scalar.value_kind(self.aux[key].dtype), v, self.luts.index(key))

    def expr(self, e) -> int:
        memo = ("col", e.name) if isinstance(e, ColumnRef) else ("expr", id(e))
        if memo in self.memo:
            return self.memo[memo]
        if isinstance(e, ColumnRef):
            if e.name not in self.env_dtypes:
                raise ValueError(f"column {e.name} is not in the block's env")
            if e.name not in self.columns:
                self.columns.append(e.name)
            v = self.emit(
                "LOAD", scalar.value_kind(self.env_dtypes[e.name]), self.columns.index(e.name)
            )
        elif isinstance(e, Constant):
            if e.data_type == DataType.STRING:
                v = self.const(int(self.aux[f"const:{id(e)}"]), scalar.I)
            else:
                v = self.const(e.value, _kind_of(e.data_type))
        else:
            v = self.call(e)
        self.memo[memo] = v
        return v

    def call(self, e: FuncCall) -> int:
        udf, arg_types = self.ev._resolved[id(e)]
        lut_key = f"lut:{id(e)}"
        if lut_key in self.aux:
            (col,) = [
                a for a, t in zip(e.args, arg_types)
                if t == DataType.STRING and isinstance(a, ColumnRef)
            ]
            return self.lut(self.expr(col), lut_key)
        if udf.executor != Executor.DEVICE:
            raise ValueError(
                f"{udf.name} is a HOST function with no precomputed table; "
                "cannot run on the device"
            )
        if e.init_args:
            raise ValueError(f"H17 takes no init args ({udf.name})")
        args = [self.coerce(self.expr(a), _kind_of(t)) for a, t in zip(e.args, arg_types)]
        name, out = udf.name, _kind_of(udf.out_type)
        fk = arg_types and arg_types[0] == DataType.FLOAT64
        if name in _ARITH:
            return self.emit(_ARITH[name] + ("_F" if out == scalar.F else "_I"), out, *args)
        if name in _CMPS:
            return self.emit(_CMPS[name] + ("_F" if fk else "_I"), scalar.B, *args)
        if name == "divide":  # f64 division whatever the overload
            a, b = (self.coerce(x, scalar.F) for x in args)
            return self.emit("DIV_F", scalar.F, a, b)
        if name == "modulo":
            return self.emit("MOD_F" if fk else "MOD_I", out, *args)
        if name in ("negate", "abs"):
            return self.emit(("NEG" if name == "negate" else "ABS") + ("_F" if fk else "_I"), out, *args)
        if name in ("logical_and", "logical_or"):
            return self.emit("AND" if name == "logical_and" else "OR", scalar.B, *args)
        if name == "logical_not":
            return self.emit("NOT", scalar.B, *args)
        if name in _TO_INT:
            return self.emit("F2I", scalar.I, self.emit(_TO_INT[name], scalar.F, *args))
        if name in _F_UNARY:
            return self.emit(_F_UNARY[name], scalar.F, *args)
        if name == "pow":
            return self.emit("POW", scalar.F, *args)
        if name == "log":  # log(b, x)
            return self.emit("LOGB", scalar.F, *args)
        if name == "bin":  # t - t % max(size, 1)
            t, size = args
            m = self.emit("MAX_I", scalar.I, size, self.const(1, scalar.I))
            if self.kinds[t] == scalar.F:
                m = self.emit("I2F", scalar.F, m)
                return self.emit("SUB_F", scalar.F, t, self.emit("MOD_F", scalar.F, t, m))
            return self.emit("SUB_I", scalar.I, t, self.emit("MOD_I", scalar.I, t, m))
        if name == "DurationNanos":
            return self.emit("F2I", scalar.I, args[0]) if fk else args[0]
        if name == "Time":
            return args[0]
        if name == "select":
            return self.emit("SELECT", out, *args)
        raise ValueError(f"H17 cannot compile {name}")

    def store(self, name: str, v: int, dtype) -> None:
        want = scalar.value_kind(dtype)
        if want == scalar.B and self.kinds[v] != scalar.B:
            raise ValueError(f"H17 cannot store kind {self.kinds[v]} as bool")
        if want == scalar.I and self.kinds[v] == scalar.F:
            raise ValueError(f"H17 stores no f64 as {dtype}")
        if want == scalar.F:
            v = self.coerce(v, scalar.F)
        self.outputs.append((name, dtype))
        self.code.append([scalar.OP["STORE"], -1, v, len(self.outputs) - 1, 0])

    def compile(self, roots, mask) -> scalar.ScalarProgram:
        passthrough = {}
        for name, e, dtype, lut in roots:
            if lut is None and isinstance(e, ColumnRef):
                passthrough[name] = (e.name, dtype)
            elif lut is None and isinstance(e, Constant) and e.data_type != DataType.STRING:
                passthrough[name] = (
                    e.value, dtype or scalar.dtype_of_kind(_kind_of(e.data_type))
                )
            else:
                v = self.expr(e)
                if lut is not None:
                    v = self.lut(v, lut)
                self.store(name, v, dtype or scalar.dtype_of_kind(self.kinds[v]))
        if mask is not None:
            base, preds = mask
            if not preds:
                passthrough["__mask__"] = (base, torch.bool)
            else:
                v = self.expr(ColumnRef(base))
                for p in preds:
                    pv = self.expr(p)
                    if self.kinds[pv] != scalar.B:
                        raise ValueError("a predicate is not boolean")
                    v = self.emit("AND", scalar.B, v, pv)
                self.store("__mask__", v, torch.bool)
        code, n_regs = self.allocate()
        return scalar.ScalarProgram(
            code=code, consts=self.consts, columns=self.columns,
            luts=self.luts, outputs=self.outputs, n_regs=n_regs, passthrough=passthrough,
        )

    def allocate(self) -> tuple[list, int]:
        """Virtual -> physical registers: each value's register is free again
        after its last read (an op reads its operands before it writes), and
        a new value takes the most recently freed one, else the lowest never
        used. Returns the code and its high-water mark (registers used)."""
        reads = _register_operands
        last: dict = {}
        for i, ins in enumerate(self.code):
            for v in reads(ins):
                last[v] = i
        free = list(range(scalar.MAX_REGS - 1, -1, -1))
        phys: dict = {}
        high = 0
        out = []
        for i, ins in enumerate(self.code):
            op, dst = ins[0], ins[1]
            srcs = reads(ins)
            new = list(ins)
            for pos, v in scalar.operand_slots(ins):
                new[pos] = phys[v]
            for v in set(srcs):
                if last[v] == i:
                    free.append(phys.pop(v))
            if dst >= 0:
                if not free:
                    raise ValueError(
                        f"the expression needs more than {scalar.MAX_REGS} registers"
                    )
                phys[dst] = free.pop()
                high = max(high, phys[dst] + 1)
                new[1] = phys[dst]
                if dst not in last:  # never read: free at once
                    free.append(phys.pop(dst))
            else:
                new[1] = 0
            out.append(new)
        if len(out) > scalar.MAX_INSTRS or len(self.consts) > scalar.MAX_CONSTS:
            raise ValueError("the program exceeds H17's instruction or constant pool")
        if (len(self.columns) > scalar.MAX_COLS or len(self.luts) > scalar.MAX_LUTS
                or len(self.outputs) > scalar.MAX_OUTS):
            raise ValueError("the program exceeds H17's column, LUT or output tables")
        return out, high


def _register_operands(ins) -> list:
    return [v for _, v in scalar.operand_slots(ins)]


def _find_parent(root, target):
    if isinstance(root, FuncCall):
        for a in root.args:
            if a is target:
                return root
            found = _find_parent(a, target)
            if found is not None:
                return found
    return None
