"""UDF/UDA/UDTF base classes.

Ref: src/carnot/udf/udf.h — ScalarUDF::Exec (:78), UDA::Update/Merge/Finalize
with optional Serialize/DeSerialize for partial aggregates (:91-104). The
reference executes row-at-a-time through virtual calls and wraps that in a
column loop (udf_wrapper.h); here the column IS the unit: a scalar UDF is a
function over whole device arrays (jit-fusable into its consumers), and a UDA
state is a pytree of fixed-shape tensors with a leading num_groups axis.

Partial aggregation (the PEM->Kelvin split, partial_op_mgr.h:94) maps to:
  update on each shard -> merge across shards (collective) -> finalize once.
``MergeKind`` declares how merge lowers onto the mesh:
  PSUM / PMAX / PMIN  — elementwise; the distributed layer emits one
                        lax.psum/pmax/pmin over ICI,
  TREE                — order-insensitive but not elementwise (t-digest):
                        all_gather states, fold with merge().
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Sequence

from pixie_tpu_torch.types import DataType, SemanticType


class Executor(enum.Enum):
    """Where a scalar UDF runs (ref: planner's scalar_udfs_run_on_executor
    placement rules). DEVICE = jax-traceable over jnp arrays; HOST = numpy
    (string/JSON/metadata funcs). HOST funcs with ``dict_compatible`` are
    applied to a string column's dictionary values only, and the result is
    gathered through the codes on device."""

    DEVICE = "device"
    HOST = "host"


class MergeKind(enum.Enum):
    PSUM = "psum"
    PMAX = "pmax"
    PMIN = "pmin"
    TREE = "tree"


@dataclasses.dataclass
class ScalarUDF:
    name: str
    arg_types: tuple[DataType, ...]
    out_type: DataType
    fn: Callable[..., Any]
    executor: Executor = Executor.DEVICE
    # HOST string funcs that are pure elementwise value->value maps can run
    # on the (tiny) dictionary instead of the full column.
    dict_compatible: bool = False
    # Optional init/non-column args appended after column args (e.g. the
    # substring pattern). The reference models these as init_args (udf.h).
    num_init_args: int = 0
    # True -> fn(ctx, *cols) receives the exec FunctionContext (metadata
    # state etc.; ref: udf.h FunctionContext).
    needs_ctx: bool = False
    # True -> fn(*cols, device=...) receives the engine's device (the
    # DeviceExecutor's, else Carnot(device=)), where a HOST function runs its
    # kernels (the transformer's encoder).
    needs_device: bool = False
    out_semantic: SemanticType | Callable | None = None
    doc: str = ""

    def infer_semantic(self, arg_semantics: Sequence[SemanticType]) -> SemanticType:
        if callable(self.out_semantic):
            return self.out_semantic(list(arg_semantics))
        if self.out_semantic is not None:
            return self.out_semantic
        return SemanticType.ST_NONE


@dataclasses.dataclass
class UDA:
    """A vectorized, group-batched user-defined aggregate.

    - ``init(num_groups, device) -> state`` dict/tensor of [num_groups, ...]
      torch tensors on ``device``
    - ``update(state, gids, *cols, mask) -> state``
    - ``merge(a, b) -> state``
    - ``finalize(state) -> column`` host or device; length num_groups
    Serialize/DeSerialize (udf.h:98-100) are free: states are pytrees.
    """

    name: str
    arg_types: tuple[DataType, ...]
    out_type: DataType
    init: Callable[[int], Any]
    update: Callable[..., Any]
    merge: Callable[[Any, Any], Any]
    finalize: Callable[[Any], Any]
    merge_kind: MergeKind = MergeKind.PSUM
    out_semantic: SemanticType | Callable | None = None
    # True when finalize output must be produced on host (e.g. JSON strings).
    host_finalize: bool = False
    # False when update() ignores its value column (count): the device
    # pipeline then skips staging/evaluating that column entirely — at
    # bench scale the count arg is gigabytes of HBM and upload time.
    reads_args: bool = True
    # Optional split of ``finalize`` for the device pipeline: the numeric
    # reduction (``device_finalize``: state -> [G]/[G,K] array, traceable)
    # fuses into the compiled mesh program so the host never re-uploads
    # state; ``format_output`` (host) turns that array into the output
    # column. When set, ``finalize`` must equal
    # format_output(device_finalize(state)) for host-path parity.
    device_finalize: Callable[[Any], Any] | None = None
    format_output: Callable[[Any], Any] | None = None
    # How STRING args are presented to update():
    #   "hash" — stable uint64 content hashes of the values (dictionary-
    #            independent; safe across unions and the distributed
    #            PARTIAL/MERGE split where every agent has its own
    #            write-side dictionary). Right for sketches.
    #   "code" — codes re-encoded into the agg node's latched per-column
    #            dictionary. Right for UDAs whose state/output must remain
    #            decodable back to the string (e.g. any(STRING)).
    #   "values" — the decoded strings, a numpy object array that never
    #            reaches a device (host-only UDAs that parse content, e.g.
    #            kmeans over JSON embeddings; the device lanes decline it).
    string_args: str = "hash"
    # True when the state lives on the CPU whatever the engine's device (a
    # host UDA that updates it row by row: a loop over device tensors would
    # wait on every element). The AggNode keeps it there through growth and
    # merges, and calls ``finalize(state, device)`` with the engine's device,
    # where the numeric reduction runs.
    host_state: bool = False
    # True when the state itself holds codes into the latched dictionary of
    # arg 0; the partial stage then ships that dictionary in the StateBatch
    # and the merge stage translates incoming codes into its own latch.
    string_state: bool = False
    # Fused-sum lane: sum-family UDAs contribute rows to ONE shared
    # per-block segment sum (H1, ops/segment.fused_segment_sums) with the
    # engine's presence counter, instead of a reduction of their own.
    #   fused_rows(col, mask) -> list of [n] rows, each an integer or bool
    #     tensor (bool, uint8, uint16, int32 or int64: H1 reads it as it
    #     lies and widens in registers), a segment.Narrow (a staged narrow
    #     column and its offset) or segment.PRESENCE (the count of valid
    #     rows, which reads nothing). Masked rows are skipped by the
    #     reduction itself; sums wrap mod 2^64 like int64 adds.
    #   fused_apply(state, totals) -> state, where totals is the [L, G]
    #     int64 per-segment sums of this UDA's rows.
    fused_rows: Callable[..., list] | None = None
    fused_apply: Callable[[Any, Any], Any] | None = None
    # True when fused_rows and update take a segment.Narrow: the fold then
    # hands a bare narrowed column over as staged instead of widening it.
    narrow_args: bool = False
    # Moment lane: sum over FLOAT64, mean, variance and stddev add their
    # f64 rows into ONE per-block f64 segment sum (H2,
    # ops/segment.f64_segment_sums) beside the fused-sum lane's H1 launch,
    # and take their counts from that launch's presence row.
    #   moment_rows(col, mask) -> list of rows, each a segment.F64Row (an
    #     f64 row for H2, its values or their squares) or an integer or
    #     bool row as fused_rows gives them (H1's launch: mean's bool
    #     predicate). The fold sums rows of equal F64Row.key() once.
    #   moment_apply(state, totals, count) -> state, where totals holds each
    #     row's [G] per-segment sums in moment_rows' order (f64 for an
    #     F64Row, int64 for an H1 row) and count is the presence row, int64
    #     [G].
    moment_rows: Callable[..., list] | None = None
    moment_apply: Callable[[Any, list, Any], Any] | None = None
    # Cell lane (r5): when the arg column arrives as small-dictionary
    # codes (the pipeline's int-dictionary staging), the pipeline computes
    # ONE per-(group, code) histogram on the MXU and hands it to the UDA
    # instead of per-row values — per-CELL updates turn scatter-bound
    # sketches (count-min) from ~27ns/row into ~4 (r5 measured).
    #   cell_update(state, hist, lut) -> state, hist: [G, C] int64 row
    #   counts per cell, lut: [C] the value each code stands for.
    # Must be row-order-independent and produce exactly what update()
    # would over the expanded rows.
    cell_update: Callable[[Any, Any, Any], Any] | None = None
    # True when a FLOAT64 arg may be staged to HBM as f32 without changing
    # results beyond the UDA's own approximation (e.g. t-digest centroids
    # and log-binned histogram sketches are f32-grained anyway). Cold
    # staging is host->HBM-transfer-bound, so halving sketch-arg bytes is
    # a first-query latency lever, not a precision trade.
    stage_f32_ok: bool = False
    doc: str = ""

    @property
    def supports_partial(self) -> bool:
        """All our UDAs are partial-aggregable by construction (states are
        serializable pytrees) — the reference gates this on Serialize support
        (partial_op_mgr.h:94)."""
        return True

    def infer_semantic(self, arg_semantics: Sequence[SemanticType]) -> SemanticType:
        if callable(self.out_semantic):
            return self.out_semantic(list(arg_semantics))
        if self.out_semantic is not None:
            return self.out_semantic
        return SemanticType.ST_NONE


@dataclasses.dataclass
class UDTF:
    """User-defined table function (ref: udtf.h) — produces a table.

    ``output_relation`` declares the produced schema; ``fn(ctx, **args)``
    returns a name->values dict matching it. Used for introspection sources
    like GetAgentStatus (vizier/funcs/md_udtfs).
    """

    name: str
    arg_spec: dict[str, DataType]
    fn: Callable[..., Any]
    output_relation: Any = None  # pixie_tpu_torch.types.Relation of produced rows
    executor: Executor = Executor.HOST
    doc: str = ""
