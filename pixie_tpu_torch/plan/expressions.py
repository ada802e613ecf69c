"""Scalar expression trees.

Ref: src/carnot/plan/scalar_expression.{h,cc} — ScalarValue / Column /
ScalarFunc / AggregateExpression with an ExpressionWalker. Type resolution
happens against the UDF registry (the reference resolves during planner
analysis and carries resolved ids in the proto; we resolve lazily but
deterministically from (name, arg types)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

from pixie_tpu_torch.types import DataType, Relation, SemanticType


class ScalarExpression:
    """Base class for scalar expression nodes (immutable)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class ColumnRef(ScalarExpression):
    """A reference to an input column by name."""

    name: str

    def __repr__(self):
        return f"col({self.name})"


@dataclasses.dataclass(frozen=True)
class Constant(ScalarExpression):
    """A literal with an explicit data type (ref: ScalarValue)."""

    value: Any
    data_type: DataType

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclasses.dataclass(frozen=True)
class FuncCall(ScalarExpression):
    """A scalar UDF call. ``init_args`` are non-column trailing arguments
    (ref: udf.h init args — e.g. the substring pattern)."""

    name: str
    args: tuple[ScalarExpression, ...]
    init_args: tuple[Any, ...] = ()

    def __repr__(self):
        parts = [repr(a) for a in self.args] + [repr(a) for a in self.init_args]
        return f"{self.name}({', '.join(parts)})"


@dataclasses.dataclass(frozen=True)
class AggregateExpression:
    """A UDA call inside an Agg operator (ref: plan AggregateExpression).

    Args are restricted to column refs / constants — the compiler hoists
    computed arguments into a preceding Map (same as the reference planner).
    """

    name: str
    args: tuple[ScalarExpression, ...]
    init_args: tuple[Any, ...] = ()

    def __repr__(self):
        return f"{self.name}({', '.join(repr(a) for a in self.args)})"


def walk(expr: ScalarExpression) -> Iterator[ScalarExpression]:
    """Post-order walk (ref: ExpressionWalker)."""
    if isinstance(expr, FuncCall):
        for a in expr.args:
            yield from walk(a)
    yield expr


def referenced_columns(expr) -> set[str]:
    """Column names an expression (or aggregate) reads."""
    if isinstance(expr, AggregateExpression):
        out: set[str] = set()
        for a in expr.args:
            out |= referenced_columns(a)
        return out
    return {e.name for e in walk(expr) if isinstance(e, ColumnRef)}


def _reject_unported(name: str, registry, arg_types=()) -> None:
    if name in getattr(registry, "not_ported", ()) or (
        (name, tuple(arg_types)) in getattr(registry, "not_ported_overloads", ())
    ):
        args = ", ".join(t.name for t in arg_types)
        raise ValueError(f"{name}({args}) is not ported yet to pixie_tpu_torch")


def expr_data_type(expr, relation: Relation, registry) -> DataType:
    """Resolve the output DataType of an expression against a relation.

    Raises KeyError for unknown columns and ValueError for unresolvable
    function overloads — the same failures the reference planner surfaces as
    compile errors.
    """
    if isinstance(expr, ColumnRef):
        return relation.col(expr.name).data_type
    if isinstance(expr, Constant):
        return expr.data_type
    if isinstance(expr, FuncCall):
        arg_types = [expr_data_type(a, relation, registry) for a in expr.args]
        udf = registry.lookup_scalar(expr.name, arg_types)
        if udf is None:
            _reject_unported(expr.name, registry, arg_types)
            raise ValueError(
                f"no scalar function {expr.name}"
                f"({', '.join(t.name for t in arg_types)})"
            )
        return udf.out_type
    if isinstance(expr, AggregateExpression):
        arg_types = [expr_data_type(a, relation, registry) for a in expr.args]
        uda = registry.lookup_uda(expr.name, arg_types)
        if uda is None:
            _reject_unported(expr.name, registry, arg_types)
            raise ValueError(
                f"no aggregate {expr.name}"
                f"({', '.join(t.name for t in arg_types)})"
            )
        return uda.out_type
    raise TypeError(f"not an expression: {expr!r}")


def expr_semantic_type(expr, relation: Relation, registry) -> SemanticType:
    """Resolve the output SemanticType (ref: udf/type_inference.h rules)."""
    if isinstance(expr, ColumnRef):
        return relation.col(expr.name).semantic_type
    if isinstance(expr, Constant):
        return SemanticType.ST_NONE
    if isinstance(expr, (FuncCall, AggregateExpression)):
        arg_types = [expr_data_type(a, relation, registry) for a in expr.args]
        arg_sems = [expr_semantic_type(a, relation, registry) for a in expr.args]
        if isinstance(expr, FuncCall):
            f = registry.lookup_scalar(expr.name, arg_types)
        else:
            f = registry.lookup_uda(expr.name, arg_types)
        return f.infer_semantic(arg_sems) if f is not None else SemanticType.ST_NONE
    raise TypeError(f"not an expression: {expr!r}")
