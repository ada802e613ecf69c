"""Compiled scalar-expression programs: the kernel H17 and its plain version.

Counterpart of the reference's device scalar evaluation (K19:
pixie_tpu/exec/expression_evaluator.py:219 ``device_eval`` and the jnp
scalar UDFs it traces), which XLA fuses into the jitted fold. Here the
expression trees a block needs (the predicates ANDed into the validity
mask, each UDA argument that is not a bare column, a LUT key's gids, the
scan's output columns) are compiled on the host, once per query, into ONE
register program (``ExpressionEvaluator.compile_program``); per block, one
launch of H17 (ops/kernels/scalar_kernels.cu) interprets it for every row
and writes one output tensor per result. On a CPU tensor ``run`` executes
the same instructions as torch ops (``eval_plain``), which is what the CPU
tests hold against the reference.

An instruction is five int32: (op, dst, a, b, c). Registers hold 8 bytes
each: a bool as int64 0 or 1 (H17's AND, OR and NOT rely on it), an int64,
or an f64's bits; the compiler knows each register's kind (B, I, F),
inserts the casts and records the program's depth ``n_regs`` (the
allocator's high-water mark). H17 runs the program as ``lower`` rewrites it
on upload: no CONST (a constant is an operand mode), an operand that the
previous value came from read from the kernel's accumulator, and only the
values that a later instruction reads from the register file written to
it. The opcodes, and the storage kinds of columns, LUTs and outputs, are
numbered as in scalar_kernels.cu (``tests/test_torch_scalars.py`` holds
both tables equal). Semantics, per op, are the reference's jnp ones:

- int64 add, sub, mul, neg and abs wrap; ``MOD_I`` is a floor modulo with
  0 for a divisor of 0 (the modulo UDF's guard) or -1 (INT64_MIN % -1 traps
  in C; jnp gives 0);
- f64 add, sub, mul, div and sqrt round each op (no FMA contraction);
  ``DIV_F`` is the divide UDF's guarded division, 0.0 for a zero divisor;
  ``MOD_F`` is jnp.remainder's form r = fmod(a, b), r += b where r != 0 and
  its sign differs from b's, 0.0 for a zero divisor;
- ``F2I`` converts as JAX does (Fault-11): NaN -> 0, >= 2^63 -> INT64_MAX,
  <= -2^63 -> INT64_MIN, else truncation toward zero; ``RINT_F`` rounds
  half to even;
- comparisons with NaN are false except ``NE_F``;
- ``LUT`` gathers entry clamp(code, 0, len - 1) of a bool, int32, int64 or
  f64 table (the reference's ``aux[lut][jnp.maximum(code, 0)]``, whose
  gather clamps the top too).
"""

from __future__ import annotations

import dataclasses
import torch

from pixie_tpu_torch.ops import kernels

# -- opcodes (scalar_kernels.cu enum Op) ------------------------------------
OPS = (
    "LOAD", "CONST", "STORE",
    "ADD_I", "SUB_I", "MUL_I", "MOD_I", "NEG_I", "ABS_I", "MAX_I",
    "ADD_F", "SUB_F", "MUL_F", "DIV_F", "MOD_F", "NEG_F", "ABS_F",
    "EQ_I", "NE_I", "LT_I", "LE_I", "GT_I", "GE_I",
    "EQ_F", "NE_F", "LT_F", "LE_F", "GT_F", "GE_F",
    "AND", "OR", "NOT", "B2I", "I2F", "F2I",
    "FLOOR_F", "CEIL_F", "RINT_F", "LN", "LOG2", "LOG10", "EXP", "SQRT",
    "POW", "LOGB", "SELECT", "LUT",
)
OP = {name: i for i, name in enumerate(OPS)}

# Register kinds.
B, I, F = 0, 1, 2

# Storage kinds of columns, LUTs and outputs (scalar_kernels.cu enum Kind).
KINDS = kernels.SCALAR_KINDS


def value_kind(dtype: torch.dtype) -> int:
    """The register kind a column or LUT of ``dtype`` loads as."""
    if dtype == torch.bool:
        return B
    if dtype.is_floating_point:
        return F
    return I


# Register file depth of H17 (kMaxRegs) and its other fixed limits
# (scalar_kernels.cu's kMax* constants).
MAX_REGS = 32
MAX_INSTRS = 512
MAX_CONSTS = 256
MAX_COLS = 64
MAX_LUTS = 32
MAX_OUTS = 64


@dataclasses.dataclass
class ScalarProgram:
    """A compiled program: ``code`` int32 [n, 5], the 8-byte constant pool
    ``consts`` (int64 bits), the input ``columns`` (env names, read in that
    order), the ``luts`` (aux keys) and the ``outputs`` [(name, dtype)] that
    the STORE ops write, in out-index order. ``passthrough`` maps a result
    that needs no program (a bare column, a constant) to its env name or
    Python value and its dtype (None: the env column's own). ``n_regs``:
    the registers the code uses (1 + its highest register)."""

    code: list
    consts: list
    columns: list
    luts: list
    outputs: list
    n_regs: int = MAX_REGS
    passthrough: dict = dataclasses.field(default_factory=dict)
    # Device copies of code and consts, per device.
    _uploaded: dict = dataclasses.field(default_factory=dict, repr=False)

    def passthrough_names(self) -> list:
        """The env columns the passthroughs hand on."""
        return list(dict.fromkeys(
            src for src, _ in self.passthrough.values() if isinstance(src, str)
        ))

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The lowered code (int32 [n, 8]) and the constant pool on ``device``."""
        key = str(device)
        if key not in self._uploaded:
            code = torch.tensor(lower(self.code), dtype=torch.int32).reshape(-1, 8)
            consts = torch.tensor(self.consts or [0], dtype=torch.int64)
            self._uploaded[key] = (code.to(device), consts.to(device))
        return self._uploaded[key]

    def run(self, env: dict, aux: dict, n: int, raw=None, offsets=None) -> dict:
        """{result name: tensor [n]} for one block: one H17 launch on a CUDA
        block (the plain interpreter on a CPU one), then the passthroughs.
        The program reads its columns from ``raw`` where given (staged
        columns as they are, a narrowed int column with its frame-of-
        reference offset in ``offsets``), else from ``env``; passthroughs
        read ``env``."""
        out: dict = {}
        if self.outputs:
            src = env if raw is None else raw
            cols = [src[c] for c in self.columns]
            offs = [int((offsets or {}).get(c, 0)) for c in self.columns]
            luts = [aux[k] for k in self.luts]
            device = cols[0].device if cols else next(iter(env.values())).device
            if device.type == "cuda":
                code, consts = self.device_tables(device)
                res = kernels.scalar_eval(
                    code, consts, [c.contiguous() for c in cols],
                    [t.contiguous() for t in luts],
                    [dt for _, dt in self.outputs], n, offs, self.n_regs,
                    any(OPS[ins[0]] in LONG_OPS for ins in self.code),
                )
            else:
                res = eval_plain(self, cols, luts, n, offs)
            out.update(zip((name for name, _ in self.outputs), res))
        for name, (src, dt) in self.passthrough.items():
            if isinstance(src, str):
                out[name] = env[src] if dt is None or env[src].dtype == dt else env[src].to(dt)
            else:
                dev = next(iter(env.values())).device
                out[name] = torch.full((n,), src, dtype=dt, device=dev)
        return out


def operand_slots(ins) -> list:
    """(position, register) of each register operand of instruction ``ins``."""
    op = OPS[ins[0]]
    if op in ("LOAD", "CONST"):
        return []
    if op in ("STORE", "LUT") or op in UNARY_OPS:
        return [(2, ins[2])]
    if op == "SELECT":
        return [(2, ins[2]), (3, ins[3]), (4, ins[4])]
    return [(2, ins[2]), (3, ins[3])]


# The ops H17 runs out of line, a call per row (scalar_kernels.cu long_op);
# a program with one runs 4 rows a thread, not 8.
LONG_OPS = frozenset({"MOD_I", "DIV_F", "MOD_F", "LN", "LOG2", "LOG10", "EXP", "SQRT", "POW",
                      "LOGB"})

# Operand sources of a lowered instruction (scalar_kernels.cu enum Mode):
# the register file, the previous value (the kernel's accumulator), a
# constant of the pool, none; two bits an operand (a, b, c from bit 0).
M_RF, M_ACC, M_CONST, M_NONE = 0, 1, 2, 3
W_RF = 1 << 6  # the instruction's value is also written to the file (kWriteRf)


def lower(code: list) -> list:
    """``code`` as H17 runs it: rows of eight int32 (op, dst, a, b, c, mode,
    0, 0). A CONST emits nothing: each operand that reads its register
    becomes an M_CONST operand holding the pool index. An operand whose
    register the previous value-writing row (not a STORE) wrote is M_ACC.
    Any other operand is M_RF, and the row that wrote its register gets
    W_RF. The values, and so the outputs, are those of ``code``."""
    rows: list = []
    writer: dict = {}  # register -> its row, or ("const", pool index)
    acc = None  # the row whose value the accumulator holds
    for ins in code:
        op = OPS[ins[0]]
        if op == "CONST":
            writer[ins[1]] = ("const", ins[2])
            continue
        row = list(ins) + [0, 0, 0]
        modes = [M_NONE] * 3
        for pos, reg in operand_slots(ins):
            w = writer[reg]
            if isinstance(w, tuple):
                modes[pos - 2], row[pos] = M_CONST, w[1]
            elif w == acc:
                modes[pos - 2] = M_ACC
            else:
                modes[pos - 2] = M_RF
                rows[w][5] |= W_RF
        row[5] |= modes[0] | modes[1] << 2 | modes[2] << 4
        if op != "STORE":
            writer[ins[1]] = acc = len(rows)
        rows.append(row)
    return rows


def _bits_to(value: int, kind: int):
    if kind == F:
        return torch.tensor([value], dtype=torch.int64).view(torch.float64)[0].item()
    if kind == B:
        return bool(value)
    return int(value)


def _floor_mod_i(a, b):
    bad = (b == 0) | (b == -1)
    r = torch.remainder(a, torch.where(bad, torch.ones_like(b), b))
    return torch.where(bad, torch.zeros_like(r), r)


def _floor_mod_f(a, b):
    zero = b == 0
    r = torch.fmod(a, torch.where(zero, torch.ones_like(b), b))
    r = torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)
    return torch.where(zero, torch.zeros_like(r), r)


def _f2i(x):
    hi, lo = x >= 2.0**63, x <= -(2.0**63)
    out = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x).to(torch.int64)
    out = torch.where(hi, torch.full_like(out, (1 << 63) - 1), out)
    return torch.where(lo, torch.full_like(out, -(1 << 63)), out)


def _div_f(a, b):
    zero = b == 0
    q = a / torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, torch.zeros_like(q), q)


_BINARY = {
    "ADD_I": torch.add, "SUB_I": torch.sub, "MUL_I": torch.mul, "MOD_I": _floor_mod_i,
    "MAX_I": torch.maximum, "ADD_F": torch.add, "SUB_F": torch.sub, "MUL_F": torch.mul,
    "DIV_F": _div_f,
    "MOD_F": _floor_mod_f,
    "EQ_I": torch.eq, "NE_I": torch.ne, "LT_I": torch.lt, "LE_I": torch.le,
    "GT_I": torch.gt, "GE_I": torch.ge, "EQ_F": torch.eq, "NE_F": torch.ne,
    "LT_F": torch.lt, "LE_F": torch.le, "GT_F": torch.gt, "GE_F": torch.ge,
    "AND": torch.logical_and, "OR": torch.logical_or, "POW": torch.pow,
    "LOGB": lambda b, x: torch.log(x) / torch.log(b),
}
_UNARY = {
    "NEG_I": torch.neg, "ABS_I": torch.abs, "NEG_F": torch.neg, "ABS_F": torch.abs,
    "NOT": torch.logical_not, "B2I": lambda a: a.to(torch.int64), "I2F": lambda a: a.to(torch.float64), "F2I": _f2i,
    "FLOOR_F": torch.floor, "CEIL_F": torch.ceil, "RINT_F": torch.round,
    "LN": torch.log, "LOG2": torch.log2, "LOG10": torch.log10, "EXP": torch.exp,
    "SQRT": torch.sqrt,
}


UNARY_OPS = frozenset(_UNARY)


def _load(col: torch.Tensor, offset: int = 0) -> torch.Tensor:
    k = value_kind(col.dtype)
    if k == B:
        return col
    if k == F:
        return col.to(torch.float64)
    return col.to(torch.int64) + offset if offset else col.to(torch.int64)


def eval_plain(program: ScalarProgram, cols: list, luts: list, n: int, offsets=None) -> list:
    """Plain version of H17: the program's instructions as torch ops on the
    inputs' device, bools as torch.bool, ints as int64 (plus the column's
    offset), floats as f64. The outputs in out-index order, each [n] of its
    dtype."""
    device = cols[0].device if cols else (luts[0].device if luts else torch.device("cpu"))
    regs: list = [None] * MAX_REGS
    outs: list = [None] * len(program.outputs)
    for op_i, dst, a, b, c in program.code:
        op = OPS[op_i]
        if op == "LOAD":
            regs[dst] = _load(cols[a], offsets[a] if offsets else 0)
        elif op == "CONST":
            dt = (torch.bool, torch.int64, torch.float64)[b]
            regs[dst] = torch.tensor(_bits_to(program.consts[a], b), dtype=dt, device=device)
        elif op == "STORE":
            dt = program.outputs[b][1]
            v = regs[a]
            if v.dtype == torch.bool and dt != torch.bool:
                v = v.to(torch.int64)
            outs[b] = v.to(dt).expand(n).contiguous()
        elif op == "SELECT":
            regs[dst] = torch.where(regs[a], regs[b], regs[c])
        elif op == "LUT":
            lut = luts[b]
            idx = torch.clamp(regs[a], 0, lut.shape[0] - 1)
            regs[dst] = _load(lut[idx])
        elif op in _UNARY:
            regs[dst] = _UNARY[op](regs[a])
        else:
            regs[dst] = _BINARY[op](regs[a], regs[b])
    return outs


def dtype_of_kind(kind: int) -> torch.dtype:
    """A register kind's natural output dtype."""
    return (torch.bool, torch.int64, torch.float64)[kind]
