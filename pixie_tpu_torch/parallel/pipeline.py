"""The device fold: source -> map/filter -> aggregate on one CUDA device.

Counterpart of pixie_tpu/parallel/pipeline.py's MeshExecutor for the simple
aggregation core. Fragments of the shapes

    MemorySource -> (Map | Filter)* -> Agg(FULL)
    MemorySource -> (Map | Filter)* -> Agg(PARTIAL, not windowed)

run here. A windowed FULL aggregation folds the window id as one more
(leading) group axis, gid' = wid * G + gid, its windows cut at the cursor's
end-of-window markers (``_windowize_key_plan``), and emits one RowBatch a
window. A PARTIAL aggregation (the PEM side of a distributed split,
``distributed/planner.py``) ships its raw UDA states, left on the device,
as the StateBatch its MERGE consumes (``_partial_state_batch``). A group
key that is one dictionary-coded string column is its codes, evaluated per
block on the device; a string key computed by a
dict_compatible host function of one dictionary column (``regex_replace``
of a request path) is the dictionary-LUT key (``_dict_lut_key``): per-code
gids gathered on the device; any other key (several columns, ints,
computed values) is densified on the host by a chunked GroupEncoder pass
over the table (cached per table version) and its gids stage as one more
per-block lane. The needed columns are staged once per table version
(parallel/staging.py, with the staging codec): a cold query of one pass
takes the reference's default streamed path (``_stream_execute``: window
k+1 packs on a background thread while window k copies on a side stream,
decodes and folds, and the windows land in one staging for the warm
cache); more than one pass, and every warm query, fold the staged blocks
(``_run_program``). The staged cache is a byte-accounted ResidencyPool
(serving/residency.py) whose entries a fold pins while it runs. With
``resident_ingest`` every table the engine creates keeps its full append
windows on the device (serving/resident.py): a query over it without time
bounds streams (the scan and the joins: assembles its staging) at the
ring's window size, and a window the ring holds is converted on the device
by H24 (``codec.convert_block``) instead of packed and copied. Every block
is folded into the UDA states by
``_make_scan_body``: ONE launch of H17 evaluates the block's compiled
scalar program (the predicates ANDed into its mask, a LUT key's gids, each
UDA argument that is not a bare column, a string-hash argument's content
hashes through its ``arghash`` LUT), the sum-family UDAs and the presence
counter go through ONE fused segment sum (kernel H1), a sketch over an
INT64 column with few values through the int-dictionary cell lane (its
(group, code) histogram by H1, folded once a pass by H20/H21), every other
UDA through its own update (H2, H3, the sketch kernels H5-H8); the states are
finalized on the device (H4, H9, H10) and fetched with one device -> host
copy per pass.

The executor runs on a mesh (distributed/mesh.py): the flat mesh ``d:1`` on
one device by default, or D shards over a list of devices (distinct cards,
or logical shards of one). The staging is shard-major (shard i holds its
rows on device i), every shard folds its own blocks into its own states,
and the states merge at the root, shard 0's device, in flat device order
(K18, ``ops/merge.py``: H29 for the elementwise states, the UDA's merge in
order for a TREE state) before the one finalize and fetch. On one shard the
merge is the identity. Every fold runs under the mesh recovery plane
(``_execute_with_recovery``): on a multi-axis mesh a lost host or a hung
dispatch re-plans the fold on the next rung of the degradation ladder (the
same devices, another factorization, the same result), the per-geometry
breaker skips a rung that keeps failing, and the stream checkpoints its
carries at every window so a re-planned fold resumes where it stopped.

``any`` over a bare column with no predicate takes the reference's host
lane (``_plan_host_any``): one representative per group from the key plan's
gids, never staged; with a predicate it folds on the device as a max (H11).

A fragment with no aggregate, of the shape

    MemorySource -> (Map | Filter)* -> Limit(n <= device_scan_limit_cap)

takes the device scan (``_try_execute_scan``): per block the predicates and
projections in one H17 launch, then the stable compaction H12 appends the
selected rows to the output buffers until ``limit`` rows are written.

A fragment with no aggregate whose one join walks to two distinct tables,

    MemorySource -> (Map | Filter)* -> Join(INNER | LEFT | RIGHT | OUTER) -> [suffix]
    MemorySource -> (Map | Filter)* ---^

takes the device sort-merge join (``_try_execute_join``, tried before the
scan as the reference tries it): both sides' keys densify on the host into
one id space, both sides stage with those ids as their gids, and
``ops/segment.local_sort_merge`` (a stable ``torch.sort``, H13, H14, H12)
and H15 build every output column on the device; the suffix runs on the host
graph against the result. On a mesh whose ``hosts`` axis is wider than 1
the join is partitioned (``_try_partitioned_join``): each host joins one
contiguous range of key ids on its own devices, and the host reorders the
sections into the same rows. A join the lane declines (the reference's gates,
and pre-join predicates, which the port does not push down yet) runs on the
host EquijoinNode with the same result.

A join that feeds an aggregation,

    MemorySource -> (Map | Filter)* -> INNER Join -> (Map | Filter)* -> Agg(FULL)
    MemorySource -> (Map | Filter)* ---^

with count/sum/mean/min/max of one column each and groups from the left
side takes the join-aggregate lane (``_try_execute_join_agg``, tried before
the standalone join as the reference tries it): the pairs are never built.
The right side reduces to per-key statistics (H1, H2, H11 over the join-key
ids) and the left side folds once with per-row weights nR[jk] (H16, then
H11 under H16's effective mask).

A fragment outside those shapes — a windowed PARTIAL or a MERGE
aggregation, an aggregation over an aggregation, a source shared with a
second sink, a string-hash or code-valued UDA over a computed string argument (only a
bare dictionary column has the content hashes or codes, as in the
reference), a tree H17 cannot run (a host function without a table), a join
the lanes decline — returns None and runs on the host exec graph: its
aggregations on the host AggNode (exec/agg_node.py), whose UDA states live
on the engine's device, so on the card they update through the same
kernels. Errors raise; nothing is caught and sent elsewhere.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from pixie_tpu_torch.compiler.analyzer import substitute
from pixie_tpu_torch.distributed.mesh import MeshGeometryError, resolve_mesh
from pixie_tpu_torch.exec.agg_node import StateBatch
from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator, call_host
from pixie_tpu_torch.exec.group_encoder import GroupEncoder
from pixie_tpu_torch.ops import batched, codec, merge, scan, segment
from pixie_tpu_torch.parallel.staging import (
    ShardedBlocks,
    StagedColumns,
    WindowStager,
    _pow2_at_least,
    int_dict_encode,
    plan_stream,
    profile_add,
    read_columns,
    read_columns_windowed,
    shard_of,
    stage_columns,
    stage_partitioned,
    staged_gid_nbytes,
    timed,
)
from pixie_tpu_torch.plan.expressions import (
    ColumnRef,
    Constant,
    FuncCall,
    expr_data_type,
    referenced_columns,
    walk,
)
from pixie_tpu_torch.plan.operators import (
    AggOp,
    AggStage,
    FilterOp,
    JoinOp,
    JoinType,
    LimitOp,
    MapOp,
    MemorySourceOp,
)
from pixie_tpu_torch.plan.plan import PlanFragment
from pixie_tpu_torch.serving.residency import ResidencyPool
from pixie_tpu_torch.serving.resident import ResidentIngestManager
from pixie_tpu_torch.serving.shared_scan import SharedScanCoordinator, aux_digest
from pixie_tpu_torch.table.column import DictColumn, StringDictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import ColumnSchema, DataType, Relation
from pixie_tpu_torch.types.dtypes import host_dtype
from pixie_tpu_torch.udf.udf import Executor
from pixie_tpu_torch.utils import faults, flags, metrics_registry, trace

_LOG = logging.getLogger("pixie_tpu_torch.parallel")
_M = metrics_registry()
_MESH_DEGRADE = _M.counter(
    "mesh_degrade_events_total",
    "Mesh geometry failures (host loss, hung dispatch) recovered by "
    "re-planning the fold on the next degradation rung.",
)
_MESH_CKPT_WINDOWS = _M.counter(
    "mesh_checkpoint_windows_total",
    "Stream-fold windows whose carried states were checkpointed to the host "
    "at the window boundary (flag mesh_fold_checkpoint).",
)
_MESH_RESUMES = _M.counter(
    "mesh_checkpoint_resumes_total",
    "Stream folds resumed from a window checkpoint on a surviving geometry "
    "instead of refolding from the first window.",
)
# A watchdog's reaper threads run one mesh dispatch at a time: an abandoned
# (timed-out) dispatch keeps it until its work has drained, and the next
# armed dispatch queues behind it (pixie_tpu/parallel/pipeline.py:1715).
_WATCHDOG_LOCK = threading.Lock()


@dataclasses.dataclass
class _Match:
    source_nid: int
    agg_nid: int
    source_op: MemorySourceOp
    agg_op: AggOp
    col_exprs: dict[str, Any]  # pre-agg column name -> expr in source terms
    predicates: list  # filter exprs in source terms
    source_relation: Any


def match_fragment(fragment: PlanFragment, relations) -> Optional[_Match]:
    """Find the source->(map|filter)*->agg chain, composing expressions into
    source-column terms along the way (pixie_tpu/parallel/pipeline.py:195)."""
    agg_nid = None
    for nid in fragment.topo_order():
        op = fragment.node(nid)
        if isinstance(op, AggOp) and (
            op.stage == AggStage.FULL
            or (op.stage == AggStage.PARTIAL and not op.windowed)
        ):
            agg_nid = nid
            break
    if agg_nid is None:
        return None
    chain = []
    cur = agg_nid
    while True:
        parents = fragment.parents(cur)
        if len(parents) != 1:
            return None
        cur = parents[0]
        op = fragment.node(cur)
        if len(fragment.children(cur)) != 1:
            return None  # shared with another branch
        if isinstance(op, MemorySourceOp):
            if op.streaming:
                return None
            source_nid = cur
            break
        if not isinstance(op, (MapOp, FilterOp)):
            return None
        chain.append(op)
    chain.reverse()
    source_rel = relations[source_nid]
    mapping = {c.name: ColumnRef(c.name) for c in source_rel}
    preds = []
    for op in chain:
        if isinstance(op, FilterOp):
            preds.append(substitute(op.expr, mapping))
        else:
            mapping = {name: substitute(e, mapping) for name, e in op.exprs}
    return _Match(
        source_nid=source_nid,
        agg_nid=agg_nid,
        source_op=fragment.node(source_nid),
        agg_op=fragment.node(agg_nid),
        col_exprs=mapping,
        predicates=preds,
        source_relation=source_rel,
    )


@dataclasses.dataclass
class _ScanMatch:
    """Source -> (Map | Filter)* -> Limit chain with no aggregate: the device
    evaluates predicates and projections and returns the first ``limit``
    surviving rows (pixie_tpu/parallel/pipeline.py:633)."""

    source_nid: int
    limit_nid: int
    source_op: MemorySourceOp
    limit: int
    out_exprs: list  # [(name, expr in source terms)]
    predicates: list
    source_relation: Any
    out_relation: Any


def match_scan_fragment(fragment: PlanFragment, relations) -> Optional[_ScanMatch]:
    """Find MemorySource -> (Map | Filter)* -> Limit with single-parent and
    single-child links (pixie_tpu/parallel/pipeline.py:652). Unbounded scans
    stay on the host: their output is the whole selection."""
    for nid in fragment.topo_order():
        op = fragment.node(nid)
        if not isinstance(op, LimitOp):
            continue
        chain = []
        cur = nid
        while True:
            parents = fragment.parents(cur)
            if len(parents) != 1:
                return None
            cur = parents[0]
            pop = fragment.node(cur)
            if len(fragment.children(cur)) != 1:
                return None
            if isinstance(pop, MemorySourceOp):
                if pop.streaming:
                    return None
                source_nid = cur
                break
            if not isinstance(pop, (MapOp, FilterOp)):
                return None
            chain.append(pop)
        chain.reverse()
        source_rel = relations[source_nid]
        mapping = {c.name: ColumnRef(c.name) for c in source_rel}
        preds = []
        for pop in chain:
            if isinstance(pop, FilterOp):
                preds.append(substitute(pop.expr, mapping))
            else:
                mapping = {name: substitute(e, mapping) for name, e in pop.exprs}
        out_rel = relations[nid]
        return _ScanMatch(
            source_nid=source_nid,
            limit_nid=nid,
            source_op=fragment.node(source_nid),
            limit=op.n,
            out_exprs=[(c.name, mapping[c.name]) for c in out_rel],
            predicates=preds,
            source_relation=source_rel,
            out_relation=out_rel,
        )
    return None


def _chain_to_source(fragment, start_nid, relations):
    """Walk (Map|Filter)* up to a non-streaming MemorySource; returns
    (source_nid, mapping, preds, relation) or None
    (pixie_tpu/parallel/pipeline.py:742)."""
    chain = []
    cur = start_nid
    while True:
        op = fragment.node(cur)
        if isinstance(op, MemorySourceOp):
            if op.streaming:
                return None
            source_nid = cur
            break
        if not isinstance(op, (MapOp, FilterOp)):
            return None
        if len(fragment.children(cur)) != 1:
            return None
        chain.append(op)
        parents = fragment.parents(cur)
        if len(parents) != 1:
            return None
        cur = parents[0]
    chain.reverse()
    rel = relations[source_nid]
    mapping = {c.name: ColumnRef(c.name) for c in rel}
    preds = []
    for op in chain:
        if isinstance(op, FilterOp):
            preds.append(substitute(op.expr, mapping))
        else:
            mapping = {n: substitute(e, mapping) for n, e in op.exprs}
    return source_nid, mapping, preds, rel


@dataclasses.dataclass
class _JoinMatch:
    """Source -> (Map|Filter)* -> Join <- (Map|Filter)* <- Source, then a host
    suffix (pixie_tpu/parallel/pipeline.py:908): the pairs are materialized
    on the device and whatever follows the join runs on the host against the
    spliced batch."""

    join_nid: int
    left_source_op: MemorySourceOp
    right_source_op: MemorySourceOp
    join_op: JoinOp
    left_exprs: dict  # left source-term mapping (pre-join chain)
    right_exprs: dict
    left_preds: list  # pre-join predicates, left source terms
    right_preds: list
    left_key_exprs: list  # join keys in left source terms
    right_key_exprs: list
    left_relation: Any
    right_relation: Any
    out_relation: Any  # join output, in output_columns order


def match_join(fragment: PlanFragment, relations) -> Optional[_JoinMatch]:
    """Match a standalone equijoin whose inputs walk to two DISTINCT
    non-streaming sources (pixie_tpu/parallel/pipeline.py:933). All four
    join types qualify; a RIGHT or OUTER join under a Limit does not (its
    unmatched probe rows come after every match here, where the host node
    interleaves them per probe batch, and a Limit keeps the first rows)."""
    join_nid = None
    for nid in fragment.topo_order():
        if isinstance(fragment.node(nid), JoinOp):
            if join_nid is not None:
                return None  # multi-join plans: the host engine's
            join_nid = nid
    if join_nid is None:
        return None
    join_op: JoinOp = fragment.node(join_nid)
    if not join_op.left_on:
        return None
    parents = fragment.parents(join_nid)
    if len(parents) != 2:
        return None
    left = _chain_to_source(fragment, parents[0], relations)
    right = _chain_to_source(fragment, parents[1], relations)
    if left is None or right is None:
        return None
    lsrc, lmap, lpreds, lrel = left
    rsrc, rmap, rpreds, rrel = right
    if lsrc == rsrc:
        return None  # self-join over one cursor: the host engine's
    if join_op.how in (JoinType.RIGHT, JoinType.OUTER):
        for nid in fragment.topo_order():
            if isinstance(fragment.node(nid), LimitOp):
                return None
    return _JoinMatch(
        join_nid=join_nid,
        left_source_op=fragment.node(lsrc),
        right_source_op=fragment.node(rsrc),
        join_op=join_op,
        left_exprs=lmap,
        right_exprs=rmap,
        left_preds=lpreds,
        right_preds=rpreds,
        left_key_exprs=[substitute(ColumnRef(k), lmap) for k in join_op.left_on],
        right_key_exprs=[substitute(ColumnRef(k), rmap) for k in join_op.right_on],
        left_relation=lrel,
        right_relation=rrel,
        out_relation=relations[join_nid],
    )


@dataclasses.dataclass
class _JoinAggMatch:
    """Source -> (Map|Filter)* -> INNER Join <- (Map|Filter)* <- Source, then
    (Map|Filter)* -> Agg(FULL, not windowed) (pixie_tpu/parallel/pipeline.py
    :704). The join's pairs are never materialized: aggregating over the
    join equals aggregating the LEFT rows with per-row weight w = (number of
    matching RIGHT rows), plus per-key RIGHT statistics gathered by join key:
    count = sum_L w; sum(left x) = sum_L x * w; sum(right y) = sum_L
    sumR[y, key]; min/max(right y) = min/max over L of minR/maxR[y, key]."""

    left_source_nid: int
    right_source_nid: int
    join_nid: int
    agg_nid: int
    left_source_op: MemorySourceOp
    right_source_op: MemorySourceOp
    join_op: JoinOp
    agg_op: AggOp
    left_exprs: dict  # left source-term mapping (pre-join chain)
    right_exprs: dict
    left_preds: list  # pre-join predicates, left source terms
    right_preds: list
    left_key_exprs: list  # join keys in left source terms
    right_key_exprs: list
    post_left_preds: list  # post-join predicates that touch only the left side
    post_right_preds: list
    left_relation: Any
    right_relation: Any
    specs: list  # [(out_name, side, arg expr in that side's source terms, agg name)]
    group_exprs: list  # [(group name, left-side expr)]


def _expr_side(expr, left_cols: set, right_cols: set):
    """0 if the expression references only left-output columns, 1 if only
    right, None if mixed/unknown (pixie_tpu/parallel/pipeline.py:775)."""
    refs = referenced_columns(expr)
    if refs <= left_cols:
        return 0
    if refs <= right_cols:
        return 1
    return None


# Aggregates with a join decomposition (pixie_tpu/parallel/pipeline.py:904).
_JOIN_DECOMPOSABLE = {"count", "sum", "mean", "min", "max"}


def match_join_agg(fragment: PlanFragment, relations) -> Optional[_JoinAggMatch]:
    """The reference's matcher (pixie_tpu/parallel/pipeline.py:786) and its
    gates: the first join of the fragment, INNER, with keys, two DISTINCT
    non-streaming sources, one child; (Map|Filter)* down to a FULL,
    non-windowed Agg with one parent; post-join predicates, groups and args
    each on one side; groups from the left side only; count/sum/mean/min/max
    with an argument."""
    join_nid = None
    for nid in fragment.topo_order():
        if isinstance(fragment.node(nid), JoinOp):
            join_nid = nid
            break
    if join_nid is None:
        return None
    join_op: JoinOp = fragment.node(join_nid)
    if join_op.how != JoinType.INNER or not join_op.left_on:
        return None
    parents = fragment.parents(join_nid)
    if len(parents) != 2 or len(fragment.children(join_nid)) != 1:
        return None
    left = _chain_to_source(fragment, parents[0], relations)
    right = _chain_to_source(fragment, parents[1], relations)
    if left is None or right is None:
        return None
    lsrc, lmap, lpreds, lrel = left
    rsrc, rmap, rpreds, rrel = right
    if lsrc == rsrc:
        return None  # self-join over one cursor: the host engine's
    # Walk DOWN from the join through (Map|Filter)* to the Agg.
    out_cols = {o: (side, name) for side, name, o in join_op.output_columns}
    post_map = {o: ColumnRef(o) for o in out_cols}
    post_preds = []
    cur = join_nid
    while True:
        children = fragment.children(cur)
        if len(children) != 1:
            return None
        cur = children[0]
        op = fragment.node(cur)
        if isinstance(op, AggOp):
            # FULL only: a PARTIAL stage must emit states for its MERGE
            # consumer, which this decomposition does not build.
            if op.windowed or op.stage != AggStage.FULL:
                return None
            if len(fragment.parents(cur)) != 1:
                return None
            agg_nid = cur
            break
        if isinstance(op, FilterOp):
            post_preds.append(substitute(op.expr, post_map))
        elif isinstance(op, MapOp):
            post_map = {n: substitute(e, post_map) for n, e in op.exprs}
        else:
            return None
    agg_op: AggOp = fragment.node(agg_nid)
    left_out = {o for o, (side, _) in out_cols.items() if side == 0}
    right_out = {o for o, (side, _) in out_cols.items() if side == 1}

    def rewrite(expr):
        side = _expr_side(expr, left_out, right_out)
        if side is None:
            return None
        src_map = lmap if side == 0 else rmap
        name_map = {
            o: substitute(ColumnRef(out_cols[o][1]), src_map)
            for o in (left_out if side == 0 else right_out)
        }
        return side, substitute(expr, name_map)

    post_left_preds, post_right_preds = [], []
    for p in post_preds:
        rw = rewrite(p)
        if rw is None:
            return None
        (post_left_preds if rw[0] == 0 else post_right_preds).append(rw[1])
    group_exprs = []
    for g in agg_op.groups:
        rw = rewrite(post_map[g] if g in post_map else ColumnRef(g))
        if rw is None or rw[0] != 0:
            return None  # groups must come from the left side
        group_exprs.append((g, rw[1]))
    specs = []
    for out_name, agg in agg_op.values:
        if agg.name not in _JOIN_DECOMPOSABLE or not agg.args:
            return None
        rw = rewrite(substitute(agg.args[0], post_map))
        if rw is None:
            return None
        specs.append((out_name, rw[0], rw[1], agg.name))
    return _JoinAggMatch(
        left_source_nid=lsrc,
        right_source_nid=rsrc,
        join_nid=join_nid,
        agg_nid=agg_nid,
        left_source_op=fragment.node(lsrc),
        right_source_op=fragment.node(rsrc),
        join_op=join_op,
        agg_op=agg_op,
        left_exprs=lmap,
        right_exprs=rmap,
        left_preds=lpreds,
        right_preds=rpreds,
        left_key_exprs=[substitute(ColumnRef(k), lmap) for k in join_op.left_on],
        right_key_exprs=[substitute(ColumnRef(k), rmap) for k in join_op.right_on],
        post_left_preds=post_left_preds,
        post_right_preds=post_right_preds,
        left_relation=lrel,
        right_relation=rrel,
        specs=specs,
        group_exprs=group_exprs,
    )


# -- predicate normalization (pixie_tpu/parallel/pipeline.py:254-545) -------
# Lowers conjunctive predicate trees to data terms
# ``(stack, column, op, int_thr, flt_thr, in_vals)``: the predicate-batched
# shared scan (``DeviceExecutor._shared_scan_run``) folds one slot per
# distinct term list. The terms are the reference's, term for term
# (tests/test_torch_shared_scan.py holds the two normalizers together).

_CMP_OPS = {
    "equal": 0, "notEqual": 1,
    "lessThan": 2, "lessThanEqual": 3,
    "greaterThan": 4, "greaterThanEqual": 5,
}
# const-on-the-left flips the comparison, not the operands.
_CMP_FLIP = {0: 0, 1: 1, 2: 4, 3: 5, 4: 2, 5: 3}


def _block_dtype(block: torch.Tensor) -> np.dtype:
    """The numpy dtype of a staged block."""
    return np.dtype(_NP_DTYPES[block.dtype])


def normalize_predicates(predicates, evaluator, staged, aux):
    """Lower ``predicates`` to conjunctive data terms ``(stack, column, op,
    int_thr, flt_thr, in_vals)``, or None when any predicate falls outside
    the normalizable class (the query then shares only through the
    identical-signature rung) (pixie_tpu/parallel/pipeline.py:271).

    The class: a comparison of a staged column against a constant (either
    order), a bare boolean column, a conjunction (``logical_and`` splits
    into more terms), an IN-list (a ``logical_or`` tree of ``equal(col,
    const)`` leaves over one column: one membership term, op 6, whose
    sorted distinct values ride the term's LUT lane), and a LUT-backed host
    function predicate over a dictionary column (``_lut_pred_term``: op 6
    over the codes its table keeps). Exactness per term: int, bool and code
    columns compare in int64 (a narrowed column widened with its offset);
    float columns in float64 with the threshold pre-rounded through the
    column's staged dtype (an f32-staged threshold through f32). Float
    IN-lists are refused; a string constant rides as its dictionary code
    from ``aux`` (-1 when unseen, equal to no row); columns staged as
    int-dictionary codes (``staged.int_dicts``) are refused. ``aux`` holds
    host values (``const:<id>`` codes, ``lut:<id>`` tables)."""
    terms = []
    for p in predicates:
        if not _normalize_pred(p, evaluator, staged, aux, terms):
            return None
    return terms


def _normalize_pred(p, evaluator, staged, aux, terms) -> bool:
    """Normalize one predicate tree into ``terms``; False refuses the
    whole attempt (pixie_tpu/parallel/pipeline.py:310)."""
    if isinstance(p, ColumnRef):
        if (
            p.name not in staged.blocks
            or p.name in staged.int_dicts
            or _block_dtype(staged.blocks[p.name]) != np.bool_
        ):
            return False
        terms.append(("i", p.name, 1, 0, 0.0, ()))  # col != 0
        return True
    if not isinstance(p, FuncCall):
        return False
    if p.name == "logical_and" and len(p.args) == 2:
        return _normalize_pred(p.args[0], evaluator, staged, aux, terms) and (
            _normalize_pred(p.args[1], evaluator, staged, aux, terms)
        )
    if p.name == "logical_or" and len(p.args) == 2:
        t = _in_list_term(p, evaluator, staged, aux)
        if t is None:
            return False
        terms.append(t)
        return True
    t = _lut_pred_term(p, evaluator, staged, aux)
    if t is not None:
        terms.append(t)
        return True
    op = _CMP_OPS.get(p.name)
    if op is None or len(p.args) != 2:
        return False
    col_const = _col_and_const(p)
    if col_const is None:
        return False
    col, const = col_const
    if isinstance(p.args[0], Constant):
        op = _CMP_FLIP[op]
    if col.name not in staged.blocks or col.name in staged.int_dicts:
        return False
    resolved = evaluator._resolved.get(id(p))
    if resolved is None:
        return False
    t0 = resolved[1][0]
    bdt = _block_dtype(staged.blocks[col.name])
    if t0 == DataType.STRING:
        if op > 1:
            return False  # only ==/!= have code-space semantics
        code = aux.get(f"const:{id(const)}")
        if code is None:
            return False
        terms.append(("i", col.name, op, int(code), 0.0, ()))
    elif t0 == DataType.FLOAT64:
        v = const.value
        if not isinstance(v, (int, float, np.floating, np.integer)) or isinstance(v, bool):
            return False
        if bdt == np.float32:
            thr = float(np.float64(np.float32(v)))
        elif bdt == np.float64:
            thr = float(v)
        else:
            return False
        terms.append(("f", col.name, op, 0, thr, ()))
    elif t0 in (DataType.INT64, DataType.TIME64NS, DataType.BOOLEAN):
        thr = _int_const(const, bdt)
        if thr is None:
            return False
        terms.append(("i", col.name, op, thr, 0.0, ()))
    else:
        return False
    return True


def _col_and_const(p):
    """(column, constant) of a two-argument call over one column and one
    constant in either order, else None."""
    a0, a1 = p.args
    if isinstance(a0, ColumnRef) and isinstance(a1, Constant):
        return a0, a1
    if isinstance(a1, ColumnRef) and isinstance(a0, Constant):
        return a1, a0
    return None


def _int_const(const, bdt: np.dtype) -> Optional[int]:
    """An int-stack threshold: the constant as an int64, None when the
    column is a float block or the value does not fit."""
    if bdt.kind == "f":
        return None
    try:
        v = int(const.value)
    except (TypeError, ValueError):
        return None
    return v if -(1 << 63) <= v < (1 << 63) else None


def _in_list_term(p, evaluator, staged, aux):
    """Fold a ``logical_or`` tree whose leaves are all ``equal(same_col,
    const)`` into one membership term ``("i", col, 6, 0, 0.0, values)``,
    the values sorted and distinct; None refuses
    (pixie_tpu/parallel/pipeline.py:401)."""
    leaves, stack = [], [p]
    while stack:
        n = stack.pop()
        if isinstance(n, FuncCall) and n.name == "logical_or" and len(n.args) == 2:
            stack.extend(n.args)
        else:
            leaves.append(n)
    col_name = None
    vals = []
    for leaf in leaves:
        if not isinstance(leaf, FuncCall) or leaf.name != "equal" or len(leaf.args) != 2:
            return None
        col_const = _col_and_const(leaf)
        if col_const is None:
            return None
        col, const = col_const
        if col_name is None:
            col_name = col.name
        elif col.name != col_name:
            return None
        if col.name not in staged.blocks or col.name in staged.int_dicts:
            return None
        resolved = evaluator._resolved.get(id(leaf))
        if resolved is None:
            return None
        t0 = resolved[1][0]
        if t0 == DataType.STRING:
            code = aux.get(f"const:{id(const)}")
            if code is None:
                return None
            vals.append(int(code))
        elif t0 in (DataType.INT64, DataType.TIME64NS, DataType.BOOLEAN):
            v = _int_const(const, _block_dtype(staged.blocks[col.name]))
            if v is None:
                return None
            vals.append(v)
        else:
            return None  # float IN-lists are refused
    if col_name is None or not vals:
        return None
    # Membership ignores order and repeats: equivalent lists share a slot.
    return ("i", col_name, 6, 0, 0.0, tuple(sorted(set(vals))))


# numpy mirrors of the comparison ids, for a LUT's per-value results.
_NP_CMP = {
    0: np.equal, 1: np.not_equal, 2: np.less,
    3: np.less_equal, 4: np.greater, 5: np.greater_equal,
}
# Most dictionary codes an op-6 term from a LUT predicate may keep: a wider
# kept set refuses normalization (the query folds solo) rather than widen
# every co-batched query's LUT lane.
_LUT_PRED_MAX_KEPT = 1024


def _lut_pred_term(p, evaluator, staged, aux):
    """A LUT-backed host-function predicate as one membership term
    (pixie_tpu/parallel/pipeline.py:487): a bare boolean function of one
    dictionary column (``f(col)``, whose table ``lut:<id>`` ``build_aux``
    made) or a comparison of such a function with a numeric constant
    (either order). Both keep the set of codes whose table entry passes:
    op 6 over the column's codes, as H17's LUT gather then compare keeps
    row code k iff lut[k] passes. None refuses: no table, a non-bool table
    on the bare shape, a string or bool constant, or more than
    ``_LUT_PRED_MAX_KEPT`` kept codes."""
    op = _CMP_OPS.get(p.name)
    const = None
    if op is not None and len(p.args) == 2:
        a0, a1 = p.args
        if isinstance(a0, FuncCall) and isinstance(a1, Constant):
            f_expr, const = a0, a1
        elif isinstance(a1, FuncCall) and isinstance(a0, Constant):
            f_expr, const = a1, a0
            op = _CMP_FLIP[op]
        else:
            return None
    elif f"lut:{id(p)}" in aux:
        f_expr, op = p, None  # bare boolean function: keep where true
    else:
        return None
    lut = aux.get(f"lut:{id(f_expr)}")
    if lut is None:
        return None
    cols = [a for a in f_expr.args if isinstance(a, ColumnRef)]
    if len(cols) != 1:
        return None
    col = cols[0]
    if col.name not in staged.blocks or col.name in staged.int_dicts:
        return None
    lut = np.asarray(lut)
    if lut.ndim != 1 or lut.dtype.kind not in "bif":
        return None
    if op is None:
        if lut.dtype != np.bool_:
            return None
        kept = lut
    else:
        v = const.value
        if not isinstance(v, (int, float, np.integer, np.floating)) or isinstance(v, bool):
            return None
        kept = _NP_CMP[op](lut, v)
    codes = np.nonzero(np.asarray(kept, dtype=bool))[0]
    if len(codes) > _LUT_PRED_MAX_KEPT:
        return None
    return ("i", col.name, 6, 0, 0.0, tuple(int(c) for c in codes))


@dataclasses.dataclass
class _HostNormShim:
    """A stand-in staging for ``normalize_predicates`` over a relation's
    host columns (pixie_tpu/parallel/pipeline.py:548-571): one empty block
    a column in its host dtype (STRING as int32 codes), so the normalizer's
    dtype gates resolve as they would against a host-geometry staging and
    no int-dictionary column applies. A UINT128 column has no block: a
    predicate on it falls outside the class."""

    blocks: dict
    int_dicts: dict = dataclasses.field(default_factory=dict)


def host_norm_shim(relation) -> _HostNormShim:
    blocks = {}
    for schema in relation:
        if schema.data_type == DataType.STRING:
            blocks[schema.name] = torch.empty(0, dtype=torch.int32)
        elif schema.data_type != DataType.UINT128:
            blocks[schema.name] = torch.from_numpy(np.empty(0, dtype=host_dtype(schema.data_type)))
    return _HostNormShim(blocks)


def predicate_fold_digest(predicates, relation, registry, func_ctx=None) -> Optional[str]:
    """The canonical digest of a conjunctive predicate list over
    ``relation``, or None when any predicate falls outside the normalizable
    class (``normalize_predicates``; pixie_tpu/parallel/pipeline.py:574).
    Two lists with the same digest keep exactly the same rows: string
    constants canonicalize by value (the normalizer runs over a private
    value-sorted code assignment, whose codes the digest translates back to
    the values), and the terms sort, so the order of a conjunction never
    splits a digest. The standalone join's pushdown keys each side's
    staging by it."""
    named = [(f"pred{i}", p) for i, p in enumerate(predicates)]
    try:
        evaluator = ExpressionEvaluator(named, relation, registry, func_ctx)
    except (ValueError, KeyError):
        return None
    svals = sorted({
        e.value for _, p in named for e in walk(p)
        if isinstance(e, Constant) and isinstance(e.value, str)
    })
    code_of = {v: i for i, v in enumerate(svals)}
    aux = {
        f"const:{id(e)}": code_of[e.value]
        for _, p in named for e in walk(p)
        if isinstance(e, Constant) and isinstance(e.value, str)
    }
    terms = normalize_predicates(predicates, evaluator, host_norm_shim(relation), aux)
    if terms is None:
        return None
    val_of_code = {c: v for v, c in code_of.items()}
    string_cols = {c.name for c in relation if c.data_type == DataType.STRING}
    canon = []
    for stack, col, op, ithr, fthr, invals in terms:
        if col in string_cols and op in (0, 1):
            canon.append((col, op, "s", val_of_code[ithr]))
        elif col in string_cols and op == 6:
            canon.append((col, op, "s", tuple(sorted(val_of_code[c] for c in invals))))
        else:
            canon.append((col, op, stack, ithr, fthr, invals))
    return "preds:" + repr(sorted(canon, key=repr))


def host_pred_mask(preds, relation, table, cols: dict, registry, func_ctx, device):
    """The AND of pre-join predicates over the host columns ``cols`` (the
    read the join keys came from), each evaluated by the ExpressionEvaluator
    the host FilterNode runs, so the kept rows, selected by the mask in row
    order, are the rows the host plan's pre-join filter keeps
    (pixie_tpu/parallel/pipeline.py:3165). None when a STRING column has no
    dictionary or no predicate reads a column; the digest's gate has already
    admitted the predicates, so an evaluation error raises."""
    needed = set()
    for p in preds:
        needed |= referenced_columns(p)
    if not needed:
        return None
    schemas, batch_cols = [], []
    for name in sorted(needed):
        schema = relation.col(name)
        arr = cols[name]
        if schema.data_type == DataType.STRING:
            d = table.dictionaries.get(name)
            if d is None:
                return None
            arr = DictColumn(np.asarray(arr).astype(np.int32), d)
        schemas.append(schema)
        batch_cols.append(arr)
    sub_rel = Relation(schemas)
    batch = RowBatch(sub_rel, batch_cols)
    mask = None
    for i, p in enumerate(preds):
        ev = ExpressionEvaluator([(f"p{i}", p)], sub_rel, registry, func_ctx, device=device)
        m = ev.evaluate_predicate(batch)
        mask = m if mask is None else (mask & m)
    return mask


@dataclasses.dataclass
class _KeyPlan:
    """How gids materialize: ``device_expr`` evaluated per block on the
    device, or ``host_gids`` densified on the host (neither: one group)."""

    device_expr: Optional[Any] = None
    host_gids: Optional[np.ndarray] = None
    num_groups: int = 0
    key_columns: list = dataclasses.field(default_factory=list)


# The register kind each column type loads as in H17's programs (its
# staged dtype may be narrower: the kernel reads what is staged). A type
# not listed (UINT128) has no register: a tree that reads one declines.
_REGISTER_DTYPES = {
    DataType.BOOLEAN: torch.bool,
    DataType.FLOAT64: torch.float64,
    DataType.INT64: torch.int64,
    DataType.TIME64NS: torch.int64,
    DataType.STRING: torch.int64,  # dictionary codes
}

def _register_dtypes(relation) -> dict:
    """The register dtype of each column an H17 program may load, and of
    the block's validity ``__valid__``."""
    dtypes = {
        c.name: _REGISTER_DTYPES[c.data_type] for c in relation
        if c.data_type in _REGISTER_DTYPES
    }
    dtypes["__valid__"] = torch.bool
    return dtypes


_NP_DTYPES = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.uint16: np.uint16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


# The cell lane's budget of (group, code) cells, the reference's
# segment.MATMUL_MAX_SEGMENTS (pixie_tpu/ops/segment.py), so that both
# packages stage the same codes and take the same lane.
CELL_MAX_CELLS = 8192


def _cell_served(arg_e, uda, cell_cols: dict) -> bool:
    """Whether a UDA reads its argument through the cell lane's column (a
    bare cell column): it then has no H17 root and takes no fused rows."""
    return uda.cell_update is not None and isinstance(arg_e, ColumnRef) and (
        arg_e.name in cell_cols
    )


def _pack_bytes(tensors: list) -> tuple:
    """(one uint8 tensor of the tensors' bytes, concatenated, each tensor's
    (dtype, shape, byte count)). The tensors share one device."""
    parts = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    meta = [(t.dtype, tuple(t.shape), p.numel()) for t, p in zip(tensors, parts)]
    return torch.cat(parts), meta


def _unpack_bytes(host: np.ndarray, meta: list) -> list:
    """The numpy arrays of ``_pack_bytes``' tensors from their host bytes."""
    out, off = [], 0
    for dtype, shape, n in meta:
        out.append(host[off : off + n].view(_NP_DTYPES[dtype]).reshape(shape))
        off += n
    return out


def _device_pairs(src, dst) -> list:
    """[(source, destination)] of two lanes of the same layout, a pair a
    device: the lanes themselves when each is one tensor, else each
    ``ShardedBlocks`` part with its counterpart."""
    if isinstance(dst, ShardedBlocks):
        return list(zip(src.parts, dst.parts))
    return [(src, dst)]


def _fetch(tensors: list) -> list:
    """Bring device tensors to the host with ONE device -> host copy: each
    is viewed as bytes, the bytes are concatenated, copied, and split. The
    tensors share one device (the root's)."""
    buf, meta = _pack_bytes(tensors)
    return _unpack_bytes(buf.cpu().numpy(), meta)


def _fetch_slots(outs: list, force_state: bool = False) -> list:
    """Each slot's pass outputs (``_finish_pass``'s: the spec outputs, then
    presence) on the host with ONE device -> host copy for all slots. With
    ``force_state`` (a PARTIAL fold) only the presences come back: the state
    leaves stay on the device, where the MERGE stage reads them."""
    if force_state:
        presence = _fetch([o[-1] for o in outs])
        return [list(o[:-1]) + [p] for o, p in zip(outs, presence)]
    host = _fetch([t for o in outs for t in o])
    out, i = [], 0
    for o in outs:
        out.append(host[i : i + len(o)])
        i += len(o)
    return out


def _copy_to_host(packed: list) -> list:
    """[(host bytes, meta)] of each ``_pack_bytes`` result, which may lie on
    different cards: every copy is enqueued (into pinned memory on CUDA)
    before any is waited for, then one wait a card."""
    out = []
    for buf, meta in packed:
        if buf.is_cuda:
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
        else:
            host = buf
        out.append((host, meta))
    for dev in dict.fromkeys(buf.device for buf, _ in packed if buf.is_cuda):
        torch.cuda.current_stream(dev).synchronize()
    return [(host.numpy(), meta) for host, meta in out]


# The scan's output buffer dtype per column type: strings as their int32
# dictionary codes, bools as int32 0/1 (H12 moves 4- and 8-byte elements).
_SCAN_DTYPES = {
    DataType.STRING: torch.int32,
    DataType.BOOLEAN: torch.int32,
    DataType.INT64: torch.int64,
    DataType.TIME64NS: torch.int64,
    DataType.FLOAT64: torch.float64,
}


class _FullProbe:
    """Whether a scan's ``written`` counter has reached its limit, learnt
    without waiting: on CUDA each ``record()`` queues a copy of the counter
    to pinned host memory, and ``full()`` reads the last copy that has
    finished (False while none has). On the CPU the counter is read
    directly."""

    def __init__(self, written: torch.Tensor, limit: int):
        self.written, self.limit = written, limit
        self.host = self.event = None
        if written.is_cuda:
            self.host = torch.zeros(1, dtype=torch.int32, pin_memory=True)

    def record(self) -> None:
        if self.host is not None and self.event is None:
            self.host.copy_(self.written, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.written.device))

    def full(self) -> bool:
        if self.host is None:
            return int(self.written[0]) >= self.limit
        if self.event is None or not self.event.query():
            return False
        self.event = None
        return int(self.host[0]) >= self.limit


def _tree_leaves(tree) -> list:
    """The leaves of a fold carry (nested dicts, lists and tuples of tensors
    and scalars), in its own order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _same_leaf_type(a, b) -> bool:
    """Whether a checkpointed leaf (a host array where the carry holds a
    tensor) fits a fresh carry's leaf."""
    if isinstance(b, torch.Tensor):
        return (isinstance(a, np.ndarray) and a.shape == tuple(b.shape)
                and a.dtype == _NP_DTYPES.get(b.dtype))
    return type(a) is type(b)


def _tree_rebuild(tree, leaves: list):
    """``tree`` with its leaves replaced, in ``_tree_leaves``' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _state_bytes(state) -> int:
    leaves = state.values() if isinstance(state, dict) else [state]
    return sum(t.numel() * t.element_size() for t in leaves)


def _program_sig(program, specs) -> tuple:
    """An H17 program's identity without the query's own names: each
    ``arg:<out>`` result named by its spec's position, each ``lut:<id>``
    table by its position (its values are in the aux digest)."""
    names = {f"arg:{out}": f"arg#{i}" for i, (out, _, _) in enumerate(specs)}
    return (
        tuple(tuple(ins) for ins in program.code),
        tuple(program.consts),
        tuple(program.columns),
        tuple("lut" if k.startswith("lut:") else k for k in program.luts),
        tuple((names.get(n, n), str(dt)) for n, dt in program.outputs),
        tuple(sorted(
            (names.get(n, n), src if isinstance(src, str) else repr(src), str(dt))
            for n, (src, dt) in program.passthrough.items()
        )),
    )


def _state_mode(uda) -> bool:
    """Whether the fold finalizes ``uda`` on the host from its fetched state
    (the reference's "state" mode, pixie_tpu/parallel/pipeline.py:4699-4710):
    its finalize makes host values (JSON strings) and it has no
    device_finalize."""
    return uda.device_finalize is None and uda.host_finalize


def _state_keys(uda) -> Optional[tuple]:
    """The sorted leaf names of ``uda``'s state (None: one tensor)."""
    st = uda.init(1, "cpu")
    return tuple(sorted(st)) if isinstance(st, dict) else None


def _sum_lane(uda) -> Optional[str]:
    """The batched fold's H23 lane of a sum-family UDA: "count" (the slot's
    presence), "sum_i" (an int64 row), "sum_f" (an f64 row), "mean" (an f64
    row and the presence); None for every other UDA (its own update, once a
    slot)."""
    if uda.name == "count":
        return "count"
    if uda.name == "sum":
        return "sum_i" if uda.fused_rows is not None else "sum_f"
    if uda.name == "mean":
        return "mean"
    return None


class DeviceExecutor:
    """Runs matching fragments on a mesh of devices. ``device=None`` is the
    ``mesh_axes`` geometry over every CUDA card (flat, ``d:<cards>``, when
    the flag is empty; raising when there is no card); a named device is
    that device alone (``d:1`` with the flag empty), ``device="cpu"`` the
    CPU, which runs the plain PyTorch versions of the kernels. A mesh of
    more shards also comes from ``mesh`` (a
    ``distributed.Mesh``), from ``mesh_config`` over ``devices`` (every
    CUDA card when None; a list may name one device several times: logical
    shards of it), or from the ``mesh_axes`` flag (``resolve_mesh``). A
    geometry that wants more devices than it is given raises ValueError."""

    def __init__(self, device=None, block_rows: Optional[int] = None, mesh=None,
                 mesh_config=None, devices=None):
        self.mesh, self.mesh_config = resolve_mesh(mesh, mesh_config, devices, device)
        # The root: shard 0's device, where states merge and finalize.
        self.device = self.mesh.root
        self._mesh_sig = self.mesh_config.signature()
        # The device list in every staged-cache and shared-scan key: a
        # staging's layout (shard i on device i) depends on it and not on
        # the factorization, so every rung of the degradation ladder (the
        # same devices) reads the same entries, as the reference's
        # geometry-free keys do.
        self._mesh_key = "devices:" + ",".join(map(str, self.mesh.devices))
        self.block_rows = (
            block_rows if block_rows is not None else flags.device_block_rows
        )
        # Staged columns per (table version, columns, key plan, ...): a table
        # version is staged once and every matching query reuses it. A
        # byte-accounted pool (serving/residency.py): LRU under the entry cap
        # and, with ``hbm_budget_mb``, the byte watermarks; a fold pins its
        # entry while it runs; resident ring windows count as pinned bytes.
        self._staged_cache = ResidencyPool(cap_entries=flags.staged_cache_cap)
        # Device-resident ingest rings (flag ``resident_ingest``), made on the
        # first ``enable_resident_ingest``.
        self._resident: Optional[ResidentIngestManager] = None
        # Host-densified key plans per (table version, key exprs, window), LRU.
        self._keyplan_cache: "collections.OrderedDict[tuple, _KeyPlan]" = (
            collections.OrderedDict()
        )
        self._keyplan_cache_cap = flags.keyplan_cache_cap
        # Host any() representatives per (table version, window, keys,
        # column), LRU.
        self._hostany_cache: "collections.OrderedDict[tuple, np.ndarray]" = (
            collections.OrderedDict()
        )
        # Concurrent queries share the key-plan and any() caches: every walk
        # or change of one holds this lock (the staged pool has its own).
        self._cache_lock = threading.Lock()
        # Concurrent compatible warm folds share one dispatch (flag
        # ``shared_scans``; ``_shared_scan_run``).
        self._shared_scans = SharedScanCoordinator()
        self.last_fold_ms: Optional[float] = None
        # K18's spans since the last merge_device_ms() (under _cache_lock).
        self._merge_marks: list = []
        # The mesh recovery plane (pixie_tpu/parallel/pipeline.py:1121-1149):
        # the degradation ladder (the full geometry first, flat last, None
        # for the host engine), one Mesh a rung over the same devices, the
        # per-geometry breaker (signature -> [failures, open until]), and
        # the stream fold's window checkpoints under a geometry-free key.
        self._geom_lock = threading.RLock()
        self._full_mesh_config = self.mesh_config
        self._geom_ladder = self.mesh_config.ladder()
        self._rung_meshes = {self._mesh_sig: self.mesh}
        self._geom_breaker: dict = {}
        self._fold_ckpt: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self._geom_events = {"degrade": 0, "checkpoint_windows": 0, "resumes": 0,
                             "recovered_folds": 0}
        # The windows of the latest checkpoint resume (bench.py config 12).
        self.last_resume_stats: Optional[dict] = None

    # -- public -------------------------------------------------------------
    def try_execute_fragment(
        self, fragment: PlanFragment, table_store, registry, func_ctx=None
    ) -> Optional[tuple[int, RowBatch]]:
        """(agg, join or limit node id, its output) when the fragment has a
        device shape, else None (the host graph then runs the fragment). The
        output is a RowBatch; a windowed aggregation's is a list of them, one
        a window, and a PARTIAL aggregation's a StateBatch. The
        fold runs under the mesh recovery plane (``_execute_with_recovery``):
        a host loss or a hung dispatch re-plans it on the next rung of the
        degradation ladder. An exhausted ladder raises its last
        MeshGeometryError (ROADMAP Difference-19)."""
        return self._execute_with_recovery(fragment, table_store, registry, func_ctx)

    # -- the mesh recovery plane -------------------------------------------------
    def _geom_breaker_open(self, sig: str) -> bool:
        if flags.mesh_breaker_threshold <= 0:
            return False
        with self._geom_lock:
            st = self._geom_breaker.get(sig)
            return st is not None and st[1] > time.monotonic()

    def _geom_breaker_record(self, sig: str, ok: bool) -> None:
        threshold = flags.mesh_breaker_threshold
        if threshold <= 0:
            return
        with self._geom_lock:
            if ok:
                self._geom_breaker.pop(sig, None)  # success closes it
                return
            st = self._geom_breaker.setdefault(sig, [0, 0.0])
            st[0] += 1
            if st[0] >= threshold:
                # Open, or open again after a failed half-open trial: new
                # folds skip this rung for the cooldown; the first fold
                # after it is the half-open trial.
                st[1] = time.monotonic() + flags.mesh_breaker_cooldown_s
                _LOG.warning(
                    "mesh geometry breaker OPEN for %.1fs: %s failed %d consecutive "
                    "folds; new folds start on the next degradation rung",
                    flags.mesh_breaker_cooldown_s, sig, st[0],
                )

    def mesh_breaker_snapshot(self) -> dict:
        """{geometry signature: {state, failures, open_remaining_s}}: state
        "open" while the cooldown runs, "half_open" after it (the next fold
        is the trial), "degrading" below the threshold."""
        if flags.mesh_breaker_threshold <= 0:
            return {}
        now = time.monotonic()
        out = {}
        with self._geom_lock:
            for sig, (fails, open_until) in self._geom_breaker.items():
                state = ("open" if open_until > now
                         else "half_open" if open_until > 0 else "degrading")
                out[sig] = {"state": state, "failures": fails,
                            "open_remaining_s": round(max(0.0, open_until - now), 3)}
        return out

    def mesh_recovery_snapshot(self) -> dict:
        """The recovery plane's state: the active and the full geometry, the
        ladder, the breaker, and the counts of degrades, checkpointed
        windows, resumes and folds recovered on a lower rung."""
        with self._geom_lock:
            full = self._full_mesh_config.signature()
            return {
                "geometry": self._mesh_sig,
                "full_geometry": full,
                "degraded": self._mesh_sig != full,
                "ladder": [c.signature() if c is not None else "host" for c in self._geom_ladder],
                "breaker": self.mesh_breaker_snapshot(),
                "degrade_events": self._geom_events["degrade"],
                "checkpoint_windows": self._geom_events["checkpoint_windows"],
                "checkpoint_resumes": self._geom_events["resumes"],
                "recovered_folds": self._geom_events["recovered_folds"],
                "checkpoints_held": len(self._fold_ckpt),
            }

    def _activate_geometry(self, cfg) -> None:
        """Point the executor at ``cfg``'s mesh over the same devices. A
        rung's Mesh is made once and reused, so restoring a rung restores
        the original object. Staged entries stay valid: every rung shares
        the same device tuple, which their keys name."""
        with self._geom_lock:
            sig = cfg.signature()
            if sig == self._mesh_sig:
                return
            mesh = self._rung_meshes.get(sig)
            if mesh is None:
                mesh = self._rung_meshes[sig] = cfg.build(self.mesh.devices)
            self.mesh, self.mesh_config, self._mesh_sig = mesh, cfg, sig

    def _execute_with_recovery(self, fragment, table_store, registry, func_ctx):
        """Walk the degradation ladder (pixie_tpu/parallel/pipeline.py:1555):
        start at the first rung whose breaker is closed (an expired cooldown
        makes it the half-open trial) and, on a recoverable
        MeshGeometryError, re-plan the SAME fold one rung down: every rung
        folds the same device list to the same result, and the stream
        resumes from its last window checkpoint. A non-recoverable error
        propagates; so does the last error of an exhausted ladder, where the
        reference hands the fragment to its host engine (Difference-19)."""
        rungs = self._geom_ladder
        last_err = None
        for i, cfg in enumerate(rungs):
            if cfg is None:
                break  # past the mesh
            sig = cfg.signature()
            if self._geom_breaker_open(sig):
                continue
            self._activate_geometry(cfg)
            try:
                out = self._try_execute_fragment(fragment, table_store, registry, func_ctx)
            except MeshGeometryError as e:
                if not e.recoverable:
                    raise
                self._geom_breaker_record(sig, ok=False)
                _MESH_DEGRADE.inc()
                with self._geom_lock:
                    self._geom_events["degrade"] += 1
                nxt = next((r.signature() for r in rungs[i + 1:] if r is not None), "host")
                if trace.ACTIVE:
                    trace.record("mesh.recover", 0, attrs={"kind": e.kind, "from": sig, "to": nxt})
                _LOG.warning("mesh geometry failure [%s] on %s: re-planning the fold on %s",
                             e.kind, sig, nxt)
                last_err = e
                continue
            self._geom_breaker_record(sig, ok=True)
            if last_err is not None and out is not None:
                with self._geom_lock:
                    self._geom_events["recovered_folds"] += 1
            return out
        if last_err is not None:
            raise last_err
        return None

    def _watchdog_deadline(self) -> Optional[float]:
        """The watchdog's deadline for one mesh dispatch: the
        ``mesh_dispatch_timeout_s`` flag when positive, else None. (The
        reference derives one from its cost model when the flag is 0,
        pixie_tpu/parallel/pipeline.py:1634-1654; the port has no cost model
        yet, so 0 arms nothing.)"""
        t = float(flags.mesh_dispatch_timeout_s)
        return t if t > 0 else None

    def _mesh_dispatch(self, fn, what: str = "fold"):
        """One sharded dispatch under the recovery plane
        (pixie_tpu/parallel/pipeline.py:1656): on a multi-axis mesh the
        fault sites ``mesh.host_loss`` and ``mesh.collective_timeout`` first
        (from one process a dead host and a hung dispatch both look like a
        dispatch that never completes), then, with a deadline armed,
        ``_watchdog_run``. With no deadline it is a plain call: one process
        that enqueues every shard's work has no rendezvous to wedge, so
        the reference's process-wide lock and block around every
        multi-axis dispatch (:1686-1710) are left out (Difference-18). A
        flat mesh, or a flat rung, never checks the sites."""
        if len(self.mesh_config.axes) > 1:
            if faults.ACTIVE:
                if faults.fires("mesh.host_loss"):
                    raise MeshGeometryError("host_loss", f"{what} on {self._mesh_sig}")
                if faults.fires("mesh.collective_timeout"):
                    raise MeshGeometryError("collective_timeout", f"{what} on {self._mesh_sig}")
            deadline = self._watchdog_deadline()
            if deadline is not None:
                return self._watchdog_run(deadline, fn, what)
        return fn()

    def _watchdog_run(self, deadline: float, fn, what: str):
        """``fn()`` on a reaper thread that then waits for the mesh's cards
        (so the deadline times the work, not its enqueue); a miss raises a
        ``collective_timeout`` MeshGeometryError and abandons the thread.
        The reaper adopts the caller's current stream of every card and
        holds ``_WATCHDOG_LOCK`` until its work has drained, so an abandoned
        dispatch delays the next armed one instead of overlapping it; the
        wait for the lock is not timed."""
        box: dict = {}
        started, done = threading.Event(), threading.Event()
        cards = [d for d in self.mesh.distinct_devices() if d.type == "cuda"]
        streams = [torch.cuda.current_stream(d) for d in cards]

        def run():
            with _WATCHDOG_LOCK:
                started.set()
                try:
                    with contextlib.ExitStack() as stack:
                        for st in streams:
                            stack.enter_context(torch.cuda.stream(st))
                        box["value"] = fn()
                        for st in streams:
                            st.synchronize()
                except BaseException as e:  # re-raised on the caller's thread
                    box["error"] = e
                finally:
                    done.set()

        threading.Thread(target=run, name="mesh-watchdog", daemon=True).start()
        started.wait()
        if not done.wait(timeout=deadline):
            raise MeshGeometryError(
                "collective_timeout",
                f"{what} exceeded the {deadline:.3f}s watchdog deadline on {self._mesh_sig}",
            )
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _checkpoints_apply(self) -> bool:
        """Window checkpoints are taken on a multi-axis full mesh only: a
        flat mesh has no rung to resume on."""
        return flags.mesh_fold_checkpoint and len(self._full_mesh_config.axes) > 1

    def _load_fold_checkpoint(self, key: str, carries: list, devices: tuple):
        """(carries, windows done) from ``key``'s checkpoint, each shard's
        leaves copied to its device in ``devices``, or (None, 0). A corrupt
        checkpoint (the ``mesh.checkpoint_corrupt`` site, or leaves whose
        count, shape or dtype differ from the fresh ``carries``) is
        discarded and the fold starts from its first window: bad carry
        state is never resumed (pixie_tpu/parallel/pipeline.py:1794)."""
        with self._geom_lock:
            ck = self._fold_ckpt.get(key)
        if ck is None:
            return None, 0
        corrupt = faults.ACTIVE and faults.fires("mesh.checkpoint_corrupt")
        fresh = [_tree_leaves(c) for c in carries]
        st = ck["state"]
        if not corrupt:
            corrupt = len(st) != len(fresh) or any(
                len(a) != len(b) or any(not _same_leaf_type(x, y) for x, y in zip(a, b))
                for a, b in zip(st, fresh)
            )
        if corrupt:
            with self._geom_lock:
                self._fold_ckpt.pop(key, None)
            _LOG.warning("discarding a corrupt mesh fold checkpoint: refolding from the "
                         "first window, never resuming bad carry state")
            return None, 0
        # .copy(): an aligned buffer of the carry's own, never the checkpoint's.
        restored = [
            _tree_rebuild(c, [torch.from_numpy(x.copy()).to(dev) if isinstance(x, np.ndarray)
                              else x for x in leaves])
            for c, leaves, dev in zip(carries, st, devices)
        ]
        return restored, int(ck["windows"])

    def _checkpoint_carries(self, key: str, windows_done: int, carries: list) -> None:
        """Every shard's carry copied to the host bit for bit, one copy a
        shard (``_copy_to_host``: pinned buffers on CUDA, one wait a card):
        the window-boundary checkpoint. The wait gives up the stream's
        overlap for this window, the flag's documented cost. The executor
        keeps the last four folds' checkpoints."""
        leaves = [_tree_leaves(c) for c in carries]
        packed = [_pack_bytes([x for x in ls if isinstance(x, torch.Tensor)]) for ls in leaves]
        host = []
        for ls, arrays in zip(leaves, (_unpack_bytes(*p) for p in _copy_to_host(packed))):
            it = iter(arrays)
            host.append([next(it) if isinstance(x, torch.Tensor) else x for x in ls])
        with self._geom_lock:
            self._fold_ckpt[key] = {"windows": int(windows_done), "state": host}
            self._fold_ckpt.move_to_end(key)
            while len(self._fold_ckpt) > 4:
                self._fold_ckpt.popitem(last=False)
            self._geom_events["checkpoint_windows"] += 1
        _MESH_CKPT_WINDOWS.inc()

    def _try_execute_fragment(
        self, fragment: PlanFragment, table_store, registry, func_ctx=None
    ) -> Optional[tuple[int, RowBatch]]:
        """One attempt of ``try_execute_fragment`` on the current rung."""
        t0 = time.perf_counter()
        table_rel = lambda op: table_store.get_relation(op.table_name)
        relations = fragment.resolve_relations(registry, table_rel)
        m = match_fragment(fragment, relations)
        if m is None:
            # No chain from one source to an aggregate: the join-aggregate
            # lane first (it never materializes the pairs), then the
            # standalone join lane, then the bounded scan, as the reference
            # orders them (pixie_tpu/parallel/pipeline.py:1911).
            out = self._try_execute_join_agg(
                fragment, relations, table_store, registry, func_ctx
            )
            if out is None:
                out = self._try_execute_join(
                    fragment, relations, table_store, registry, func_ctx
                )
            if out is None:
                out = self._try_execute_scan(
                    fragment, relations, table_store, registry, func_ctx
                )
            if out is not None:
                self.last_fold_ms = (time.perf_counter() - t0) * 1e3
            return out
        table = table_store.get_table(m.source_op.table_name)
        if table is None:
            return None
        specs = self._agg_specs(m, registry)
        if specs is None:
            return None
        evaluator = self._make_evaluator(m, specs, registry, func_ctx)
        if evaluator is None:
            return None
        # match_fragment takes FULL (windowed or not) and non-windowed
        # PARTIAL (pixie_tpu/parallel/pipeline.py:1942).
        partial = m.agg_op.stage == AggStage.PARTIAL
        windowed = m.agg_op.windowed and not partial
        # any() over a bare column with no predicate may take the host lane
        # (_plan_host_any) in a FULL, unwindowed fold: its column is not
        # staged unless that lane falls through. UDAs that never read their
        # column (count) stage nothing.
        any_candidates = set()
        if not m.predicates and not partial and not windowed:
            any_candidates = {
                out for out, arg_e, uda in specs
                if uda.name == "any" and uda.reads_args and isinstance(arg_e, ColumnRef)
            }
        base_cols = set()
        for e in m.predicates:
            base_cols |= referenced_columns(e)
        for out, e, uda in specs:
            if uda.reads_args and out not in any_candidates:
                base_cols |= referenced_columns(e)
        key_plan = self._plan_keys(m, table, registry, func_ctx, base_cols)
        if key_plan is None:
            return None
        base_groups = max(key_plan.num_groups, 1)
        n_windows = 1
        if windowed:
            with timed("key_plan"):
                wk = self._windowize_key_plan(m, table, key_plan, base_groups)
            if wk is None:
                return None
            key_plan, n_windows = wk
        with timed("host_any"):
            host_any = (
                self._plan_host_any(m, specs, key_plan, table) if any_candidates else {}
            )
        for out, e, uda in specs:
            if out in any_candidates and out not in host_any:
                base_cols |= referenced_columns(e)  # back to the device lane
        device_specs = [sp for sp in specs if sp[0] not in host_any]
        capacity, n_passes = self._pass_plan(device_specs, key_plan.num_groups)
        cell_cols = self._cell_cols(m, device_specs, capacity)
        roots = []
        for out, arg_e, uda in device_specs:
            if uda.reads_args and not _cell_served(arg_e, uda, cell_cols):
                lut = f"arghash:{arg_e.name}" if uda.string_args == "hash" and isinstance(
                    arg_e, ColumnRef) and arg_e.name in table.dictionaries else None
                roots.append((f"arg:{out}", arg_e, None, lut))
        if isinstance(key_plan.device_expr, tuple):
            # The dictionary-LUT key: per-code gids gathered on the device.
            roots.append(("__gids__", ColumnRef(key_plan.device_expr[1]), torch.int32, "keylut"))
        elif key_plan.device_expr is not None:
            roots.append(("__gids__", key_plan.device_expr, torch.int32, None))
        host_aux: dict = {}
        compiled = self._compile(evaluator, table, m.source_relation, roots, m.predicates,
                                 specs=device_specs, key_plan=key_plan, host_aux=host_aux)
        if compiled is None:
            return None
        program, aux = compiled
        f32_cols = self._sketch_f32_cols(m, device_specs)
        # A windowed staging (its gids hold the window ids) never serves an
        # unwindowed query, nor the reverse (pixie_tpu/parallel/pipeline.py:2003).
        key_sig = repr([m.col_exprs[g] for g in m.agg_op.groups]) + ":dev" + (
            f":win{n_windows}" if windowed else ""
        )
        cache_key = self._staged_key(
            table, m.source_op, base_cols, key_sig, key_plan.num_groups, f32_cols, cell_cols
        )
        staged_key, staged = self._staged_lookup(cache_key)
        outputs = None
        if staged is None:
            base_row = table.min_row_id()
            with timed("read_columns"):
                cols, n = read_columns(
                    table, sorted(base_cols), m.source_op.start_time, m.source_op.stop_time
                )
            if key_plan.host_gids is not None and len(key_plan.host_gids) != n:
                return None  # the table moved under the key plan (:2076)
            if flags.streaming_stage and n_passes == 1:
                # The reference's default cold path: the aggregate is folded
                # window by window while the table stages. More than one
                # pass re-scans the staged blocks, so it stages in one piece
                # (pixie_tpu/parallel/pipeline.py:5982-5985).
                # The checkpoint identity, only where checkpoints apply:
                # the staging's key (the table version, the columns, the
                # key plan, the devices), the program with its aux values
                # and the fold's lanes; no geometry, so a resume on
                # another rung finds it.
                ckpt_ident = None
                if self._checkpoints_apply():
                    ckpt_ident = repr((
                        cache_key, _program_sig(program, device_specs),
                        aux_digest(list(host_aux.values())),
                        self._fold_lanes(device_specs, key_plan, capacity, n_passes, cell_cols),
                    ))
                with timed("stage"):
                    outputs, staged = self._stream_execute(
                        device_specs, program, key_plan, aux, cols, n, f32_cols, cell_cols,
                        capacity, self._resident_ring(table, m.source_op), base_row,
                        ckpt_ident=ckpt_ident, force_state=partial,
                    )
                segment.lane_count("stage_stream")
            else:
                staged = self._stage_monolithic(cols, n, key_plan, f32_cols, cell_cols)
                segment.lane_count("stage_monolithic")
            self._staged_insert(cache_key, staged)
        if outputs is None:
            aux = self._with_intdicts(aux, staged)
            # The fold pins its entry: no eviction retires it in flight.
            with self._staged_cache.pin(staged_key), timed("fold"):
                if flags.shared_scans:
                    outputs, capacity = self._shared_scan_run(
                        m, device_specs, evaluator, table, key_plan, roots, program, aux,
                        host_aux, staged_key, staged, cell_cols,
                    )
                else:
                    outputs, capacity = self._run_program(
                        device_specs, program, key_plan, staged, aux, cell_cols,
                        force_state=partial,
                    )
        elif flags.shared_scans and trace.ACTIVE:
            # The stream computed the fold while staging: nothing to share,
            # but the span family stays uniform (pipeline.py:2160-2168).
            trace.record(
                "serving.shared_scan", 0,
                attrs={"shared_scan_batch_size": 1, "role": "stream"},
            )
        segment.lane_count("fold_key_" + (
            "host" if key_plan.host_gids is not None
            else "lut" if isinstance(key_plan.device_expr, tuple)
            else "codes" if key_plan.device_expr is not None else "none"
        ))
        if any(lut and lut.startswith("arghash:") for _, _, _, lut in roots):
            segment.lane_count("arghash")
        if partial:
            batch = self._partial_state_batch(m, device_specs, key_plan, outputs, table)
            segment.lane_count("fold_partial")
        elif windowed:
            segment.lane_count("fold_windowed")
            # One RowBatch a window, in window order, eow on each and eos on
            # the last, as the host AggNode emits them (:2181-2198).
            batch = [
                self._finalize(
                    m, specs, key_plan, outputs, registry, table, host_any=host_any,
                    group_range=(w * base_groups, base_groups), eos=w == n_windows - 1,
                )
                for w in range(n_windows)
            ]
        else:
            batch = self._finalize(
                m, specs, key_plan, outputs, registry, table, host_any=host_any
            )
        self.last_fold_ms = (time.perf_counter() - t0) * 1e3
        return m.agg_nid, batch

    def clear_caches(self) -> None:
        """Drop the staged columns, key plans and host any() representatives:
        the next query of every table is cold. The resident ring windows
        stay (they are the table's ingest, not a query's staging)."""
        self._staged_cache.clear(reason="clear")
        with self._cache_lock:
            self._keyplan_cache.clear()
            self._hostany_cache.clear()

    # -- device-resident ingest --------------------------------------------------
    def enable_resident_ingest(self, table):
        """Attach a device ring to ``table``'s appends (flag
        ``resident_ingest``; the engine calls it from the table store's
        create listener, so every new table opts in;
        pixie_tpu/parallel/pipeline.py:1252). Returns the ring or None."""
        if not flags.resident_ingest:
            return None
        return self._resident_manager().enable(table)

    def _resident_manager(self) -> ResidentIngestManager:
        """The ring registry, its rings sharded over the full geometry's
        mesh (the rung the executor was built on)."""
        with self._cache_lock:
            if self._resident is None:
                full = self._rung_meshes[self._full_mesh_config.signature()]
                self._resident = ResidentIngestManager(full, self.block_rows, self._staged_cache)
            return self._resident

    def _resident_ring(self, table, source_op):
        """The table's ring when the resident path applies: a ring exists,
        ``resident_ingest`` is on, the executor is on the full geometry and
        the query has no time bounds (window w of the plan is ring window
        (min_row + w * W) / W only when the cursor returns every row;
        pixie_tpu/parallel/pipeline.py:1296). On a degraded rung the ring
        serves nothing, as the reference's ring windows are sharded on its
        full mesh only (:1305-1310); it serves again once the full rung is
        restored (the same Mesh object)."""
        if self._resident is None or not flags.resident_ingest:
            return None
        if self._resident.mesh is not self.mesh:
            return None
        if source_op.start_time is not None or source_op.stop_time is not None:
            return None
        return self._resident.ring_for(source_op.table_name)

    @staticmethod
    def _resident_hits(ring, plan, base_row: int, col_names) -> dict:
        """{plan window: its resident window} for every full plan window the
        ring holds with all ``col_names``; none when the plan's geometry is
        not the ring's (a plan clamped to a small table)."""
        if ring is None or plan.window_rows != ring.window_rows or (
            (plan.d, plan.nblk, plan.b) != (ring.d, ring.nblk, ring.b)
        ):
            return {}
        hits = {}
        for w in range(plan.n_windows):
            rw = ring.lookup(base_row + w * plan.window_rows, plan.rows_of(w), col_names)
            if rw is not None:
                hits[w] = rw
        return hits

    @staticmethod
    def _convert_resident_window(plan, rw, staged: StagedColumns, w: int) -> None:
        """Resident window ``rw``'s raw blocks, converted to the plan's block
        dtypes on the device (``codec.convert_block``: H24), into window
        ``w``'s slice of ``staged``: bit for bit the host pack, no wire bytes
        (pixie_tpu/parallel/pipeline.py:1396). One launch a device: the D
        shards of a one-device mesh at once (the slice is D runs at the
        staging's shard stride), a shard a card over distinct cards. A
        "raw" column whose dtype already matches is one device-to-device copy
        a device, not K8: timed apart as ``stage_resident_identity`` inside
        ``stage_resident_convert``."""
        t0 = time.perf_counter()
        lo, hi = w * plan.nblk, (w + 1) * plan.nblk
        for name, block in staged.blocks.items():
            col_plan = plan.col_plans[name]
            pairs = _device_pairs(rw.blocks[name], block[:, lo:hi])
            if col_plan[0] == "raw" and pairs[0][0].dtype == pairs[0][1].dtype:
                t1 = time.perf_counter()
                for raw, out in pairs:
                    out.copy_(raw)
                profile_add("stage_resident_identity", time.perf_counter() - t1)
                segment.lane_count("convert_identity")
                continue
            for raw, out in pairs:
                codec.convert_block(col_plan, raw, out=out, int_dtype=plan.block_dtypes[name])
            segment.lane_count(f"convert_{col_plan[0]}")
        profile_add("stage_resident_convert", time.perf_counter() - t0)
        profile_add("stage_resident_hits", 1.0)

    def _try_resident_assemble(self, table, source_op, cols: dict, n: int, gids, num_groups: int,
                               base_row: int) -> Optional[StagedColumns]:
        """The staging of ``cols`` assembled from the table's resident ring
        windows plus the staged tail (pixie_tpu/parallel/pipeline.py:4008):
        planned as a stream at the ring's window size, a hit window
        converted on the device into its slice, a miss window packed and
        copied (with the codec) by a WindowStager; only a hit window's gids
        travel. None when no ring applies, the geometry is not the ring's,
        or no window hits; an error raises (the reference stages in one
        piece instead)."""
        ring = self._resident_ring(table, source_op)
        if ring is None or n <= 0 or not cols:
            return None
        plan = plan_stream(
            cols, n, ring.window_rows, block_rows=self.block_rows,
            num_groups=max(num_groups, 1), has_gids=gids is not None, gids=gids,
            d=self.mesh.size,
        )
        hits = self._resident_hits(ring, plan, base_row, sorted(cols))
        if not hits:
            return None
        stager = WindowStager(plan, self.mesh.devices)
        for w in range(plan.n_windows):
            win = stager.pack(cols, gids, w, skip_cols=w in hits)
            if w in hits:
                self._convert_resident_window(plan, hits[w], stager.staged, w)
            stager.put(win)
            profile_add("stage_bytes", plan.window_block_nbytes() + staged_gid_nbytes(win.gids))
            profile_add("wire_bytes", win.wire_nbytes)
        segment.lane_count("stage_resident")
        return stager.staged

    # -- the scan (filter / project / limit, no aggregate) ---------------------
    def _try_execute_scan(
        self, fragment, relations, table_store, registry, func_ctx
    ) -> Optional[tuple[int, RowBatch]]:
        """(limit node id, the first ``limit`` surviving rows) for a bounded
        scan (pixie_tpu/parallel/pipeline.py:3793), else None. STRING outputs
        must be bare source columns: they stay codes of the table's
        dictionary and come back as DictColumns of it."""
        m = match_scan_fragment(fragment, relations)
        if m is None or m.limit > flags.device_scan_limit_cap:
            return None
        dtypes = [_SCAN_DTYPES.get(m.out_relation.col(name).data_type) for name, _ in m.out_exprs]
        if None in dtypes or len(dtypes) > scan.kernels.SCAN_MAX_COLS:
            return None
        table = table_store.get_table(m.source_op.table_name)
        if table is None:
            return None
        for name, e in m.out_exprs:
            if m.out_relation.col(name).data_type == DataType.STRING and (
                not isinstance(e, ColumnRef) or e.name not in table.dictionaries
            ):
                return None
        named = [(f"pred{i}", p) for i, p in enumerate(m.predicates)]
        named += [(f"out:{name}", e) for name, e in m.out_exprs]
        try:
            evaluator = ExpressionEvaluator(named, m.source_relation, registry, func_ctx,
                                            device=self.device)
        except ValueError:
            return None
        roots = [(f"out:{name}", e, dt, None) for (name, e), dt in zip(m.out_exprs, dtypes)]
        compiled = self._compile(evaluator, table, m.source_relation, roots, m.predicates)
        if compiled is None:
            return None
        program, aux = compiled
        base_cols = set()
        for _, e in named:
            base_cols |= referenced_columns(e)
        key, staged = self._stage_cached(table, m.source_op, base_cols, ":scan", 0)
        with self._staged_cache.pin(key), timed("fold"):
            rows = self._run_scan(m, program, staged, aux, dtypes)
        out_cols = []
        for (name, e), arr in zip(m.out_exprs, rows):
            schema = m.out_relation.col(name)
            if schema.data_type == DataType.STRING:
                out_cols.append(DictColumn(arr, table.dictionaries[e.name]))
            else:
                out_cols.append(arr.astype(host_dtype(schema.data_type)))
        return m.limit_nid, RowBatch(m.out_relation, out_cols, eow=True, eos=True)

    def _run_scan(self, m: _ScanMatch, program, staged, aux, dtypes) -> list:
        """Every block's predicates ANDed into its validity mask and its
        output expressions cast to their buffers' dtypes (int32 codes for
        strings) by one H17 launch, the selected rows compacted into buffers
        of ``limit`` rows by H12. Each shard compacts its own rows into its
        own buffers, up to ``limit`` (pixie_tpu/parallel/pipeline.py:4126);
        then the host takes the shards' prefixes in device order up to
        ``limit`` rows (:3900-3915): one fetch of the ``written`` counters
        and one of the prefixes taken.
        On CUDA the host copies a shard's ``written`` back without waiting
        after each block and stops enqueuing that shard's blocks once a
        finished copy shows its limit reached (the kernel already returns at
        once for a full scan, so where the host stops changes no result)."""
        shards = []
        for s, a in enumerate(self._replicate(aux)):
            dev = staged.shard_device(s)
            bufs = [torch.zeros(m.limit, dtype=dt, device=dev) for dt in dtypes]
            written = torch.zeros(1, dtype=torch.int32, device=dev)
            shards.append((staged.shard(s), a, bufs, written, _FullProbe(written, m.limit)))
        for blk in range(staged.num_blocks):
            live = [sh for sh in shards if not sh[4].full()]
            if not live:
                break
            for sv, a, bufs, written, probe in live:
                vals = self._run_block(program, sv, blk, a)
                cols = [vals[f"out:{name}"].contiguous() for name, _ in m.out_exprs]
                scan.compact_rows(vals["__mask__"].contiguous(), cols, written, bufs, m.limit)
                probe.record()
        counts = _fetch([merge.to_root(sh[3], self.device) for sh in shards])
        parts, remaining = [], m.limit
        for (_, _, bufs, _, _), w in zip(shards, counts):
            take = min(int(w[0]), remaining)
            if take > 0:
                parts.append([merge.to_root(b[:take], self.device) for b in bufs])
                remaining -= take
        if not parts:
            return _fetch([b[:0] for b in shards[0][2]])
        if len(parts) == 1:
            return _fetch(parts[0])
        return _fetch([torch.cat(cols) for cols in zip(*parts)])

    # -- the standalone join (sort-merge lane) ---------------------------------
    def _try_execute_join(
        self, fragment, relations, table_store, registry, func_ctx
    ) -> Optional[tuple[int, RowBatch]]:
        """(join node id, the joined rows) for a standalone equijoin, else
        None (pixie_tpu/parallel/pipeline.py:2881, its replicated one-device
        path). The gates are the reference's: the ``device_join`` flag, a
        matched shape, bare-column keys and outputs, a dictionary for every
        STRING output, two non-empty sides of ``device_join_min_rows`` rows or
        more together, at most 2^22 key ids, and at most
        ``device_join_max_out`` output rows. One more is the port's: a
        UINT128 key or output (staging has no 128-bit lane) declines too. A
        declined join runs on the host EquijoinNode with the same result.

        Pre-join predicates push down (:2905-2985): a side's predicates
        must fall inside the normalizable class (``predicate_fold_digest``
        is their gate, before anything runs), are evaluated on the host over
        the read the keys came from (``host_pred_mask``), and select that
        side's rows by mask, in row order, before its keys encode and its
        columns stage; each side's digest joins the staging's identity. A
        side with no row left declines, and ``device_join_min_rows`` counts
        the selected rows."""
        if not flags.device_join:
            return None
        m = match_join(fragment, relations)
        if m is None:
            return None
        digests = []
        for preds, rel in ((m.left_preds, m.left_relation), (m.right_preds, m.right_relation)):
            digest = predicate_fold_digest(preds, rel, registry, func_ctx) if preds else ""
            if digest is None:
                return None
            digests.append(digest)
        lt = table_store.get_table(m.left_source_op.table_name)
        rt = table_store.get_table(m.right_source_op.table_name)
        if lt is None or rt is None:
            return None
        if not all(isinstance(e, ColumnRef) for e in m.left_key_exprs + m.right_key_exprs):
            return None
        out_plan = []  # [(side, source column, out name, DataType)]
        for side, in_col, out_name in m.join_op.output_columns:
            e = substitute(ColumnRef(in_col), m.left_exprs if side == 0 else m.right_exprs)
            if not isinstance(e, ColumnRef):
                return None
            dt = m.out_relation.col(out_name).data_type
            if dt == DataType.UINT128:
                return None
            if dt == DataType.STRING and (lt if side == 0 else rt).dictionaries.get(e.name) is None:
                return None
            out_plan.append((side, e.name, out_name, dt))
        key_types = [m.left_relation.col(e.name).data_type for e in m.left_key_exprs]
        key_types += [m.right_relation.col(e.name).data_type for e in m.right_key_exprs]
        if DataType.UINT128 in key_types:
            return None
        sides = []
        for table, op, keys, preds, rel in (
            (lt, m.left_source_op, m.left_key_exprs, m.left_preds, m.left_relation),
            (rt, m.right_source_op, m.right_key_exprs, m.right_preds, m.right_relation),
        ):
            need = {e.name for e in keys}
            for p in preds:
                need |= referenced_columns(p)
            with timed("read_columns"):
                cols, n = read_columns(table, sorted(need), op.start_time, op.stop_time)
            sel = None
            if preds:
                with timed("join_pushdown"):
                    sel = host_pred_mask(preds, rel, table, cols, registry, func_ctx,
                                         self.device)
                    if sel is None:
                        return None
                    cols = {c: np.asarray(a)[sel] for c, a in cols.items()}
                    n = int(np.count_nonzero(sel))
            sides.append((cols, n, sel))
        (lcols, nl, left_sel), (rcols, nr, right_sel) = sides
        if nl == 0 or nr == 0 or nl + nr < flags.device_join_min_rows:
            return None  # a trivial side or a small join: the host node's
        with timed("key_plan"):
            kl, kr, K = self._join_key_ids(m, lt, rt, lcols, rcols)
        if kl is None or K > (1 << 22):
            return None
        # Exact output counts from host bincounts: they size the sections and
        # slice the result.
        count_l = np.bincount(kl, minlength=K).astype(np.int64)
        count_r = np.bincount(kr, minlength=K).astype(np.int64)
        how = m.join_op.how
        probe_outer = how in (JoinType.RIGHT, JoinType.OUTER)
        build_outer = how in (JoinType.LEFT, JoinType.OUTER)
        M = int((count_l * count_r).sum())
        UR = int(count_r[count_l == 0].sum()) if probe_outer else 0
        UL = int(count_l[count_r == 0].sum()) if build_outer else 0
        if M + UR + UL > flags.device_join_max_out:
            return None
        cap_m = _pow2_at_least(max(M, 1))
        cap_r = _pow2_at_least(max(UR, 1)) if probe_outer else 0
        cap_l = _pow2_at_least(max(UL, 1)) if build_outer else 0
        # Both sides' staging identity pins the WHOLE key space: left keys
        # encode first, so a write to either table changes both sides' ids.
        key_space_sig = repr((
            m.left_source_op.table_name, (lt.min_row_id(), lt.end_row_id()),
            m.right_source_op.table_name, (rt.min_row_id(), rt.end_row_id()),
            repr(m.left_key_exprs) + repr(m.right_key_exprs),
            m.left_source_op.start_time, m.left_source_op.stop_time,
            m.right_source_op.start_time, m.right_source_op.stop_time,
            *digests,
        ))
        # A side with no output column still needs its mask and ids on the
        # device: it stages its first key column.
        cols_l = {src for side, src, _, _ in out_plan if side == 0} or {m.left_key_exprs[0].name}
        cols_r = {src for side, src, _, _ in out_plan if side == 1} or {m.right_key_exprs[0].name}
        if (flags.mesh_distributed_join and len(self.mesh_config.axes) > 1
                and self.mesh.shape[0] > 1):
            # The partitioned join over the hosts axis (:3089-3097): each
            # host joins its own key range. None falls through to the
            # replicated lane below, never to the host.
            batch = self._try_partitioned_join(
                m, lt, rt, kl, kr, K, count_l, count_r, out_plan, key_space_sig,
                cols_l, cols_r, nl, nr, left_sel, right_sel,
            )
            if batch is not None:
                return m.join_nid, batch
        key_l, staged_l = self._stage_cached(
            lt, m.left_source_op, cols_l, ":joindevL:" + key_space_sig, K, gids=kl,
            row_sel=left_sel,
        )
        key_r, staged_r = self._stage_cached(
            rt, m.right_source_op, cols_r, ":joindevR:" + key_space_sig, K, gids=kr,
            row_sel=right_sel,
        )
        if (staged_l is None or staged_r is None
                or staged_l.num_rows != nl or staged_r.num_rows != nr):
            return None  # a table moved between the key read and the staging
        pool = self._staged_cache
        with pool.pin(key_l), pool.pin(key_r), timed("fold"):
            batch = self._run_device_join(
                m, lt, rt, staged_l, staged_r, out_plan, (M, UR, UL), (cap_m, cap_r, cap_l), K
            )
        return m.join_nid, batch

    @staticmethod
    def _join_key_ids(m, lt, rt, lcols: dict, rcols: dict):
        """(left ids, right ids, K): both sides' join keys densified into one
        id space by one GroupEncoder, left first, so right-only keys get ids
        the left never uses; string keys align through one shared
        StringDictionary first (pixie_tpu/parallel/pipeline.py:3012-3048).
        (None, None, 0) when a string key lacks a dictionary or meets a
        non-string key."""
        lkeys, rkeys = [], []
        for le, re_ in zip(m.left_key_exprs, m.right_key_exprs):
            la, ra = lcols[le.name], rcols[re_.name]
            lt_dt = m.left_relation.col(le.name).data_type
            rt_dt = m.right_relation.col(re_.name).data_type
            if DataType.STRING in (lt_dt, rt_dt):
                dl, dr = lt.dictionaries.get(le.name), rt.dictionaries.get(re_.name)
                if lt_dt != rt_dt or dl is None or dr is None:
                    return None, None, 0
                shared = StringDictionary()
                lut_l = shared.encode(np.asarray(list(dl.values()), dtype=object))
                lut_r = shared.encode(np.asarray(list(dr.values()), dtype=object))
                la = lut_l[la] if len(lut_l) else la
                ra = lut_r[ra] if len(lut_r) else ra
            lkeys.append(np.asarray(la))
            rkeys.append(np.asarray(ra))
        enc = GroupEncoder()
        kl = enc.encode(lkeys)
        kr = enc.encode(rkeys)
        return kl, kr, max(enc.num_groups, 1)

    def _run_device_join(
        self, m: _JoinMatch, lt, rt, staged_l, staged_r, out_plan, counts, caps, K
    ) -> RowBatch:
        """The join on the device (pixie_tpu/parallel/pipeline.py:3209), the
        replicated lane: both sides' shards gather to the root in device
        order (the reference all_gathers them, :3276-3283), which is row
        order, and the sort-merge runs there. (On a mesh whose ``hosts`` axis
        is wider than 1 the partitioned join, ``_try_partitioned_join``,
        runs instead, with the same rows.)
        Padded build rows take key K and padded probe rows K + 1, so neither
        pairs; ``local_sort_merge`` gives the pairs and the compacted
        unmatched rows, and H15 builds each output column as three sections
        [matched cap_m | unmatched probe cap_r | unmatched build cap_l]. The
        first M, UR and UL rows of the sections come back in ONE device ->
        host copy. Null rows carry the host node's type defaults: code -1 for
        STRING (the code of "" in a copy of the dictionary), 0 or False
        otherwise. Pairs are probe-row-major with each key's build rows in
        their original order, then the unmatched probe rows, then the
        unmatched build rows, each in row order."""
        M, UR, UL = counts
        cap_m, cap_r, cap_l = caps
        segment.lane_count("join_sort_merge")
        flat = self._flat_on_root
        lmask = flat(staged_l.mask)
        rmask = flat(staged_r.mask)
        lkey = torch.where(lmask, flat(staged_l.gids).to(torch.int32), K)
        rkey = torch.where(rmask, flat(staged_r.gids).to(torch.int32), K + 1)
        build_rows, probe_rows, _, ur, ul = segment.local_sort_merge(
            lkey, rkey, lmask, rmask, cap_m, cap_r, cap_l, K
        )
        parts, firsts = [], {}
        for i, (side, src, _, dt) in enumerate(out_plan):
            staged = staged_l if side == 0 else staged_r
            sections = (
                [(build_rows, cap_m), (None, cap_r), (ul, cap_l)]
                if side == 0
                else [(probe_rows, cap_m), (ur, cap_r), (None, cap_l)]
            )
            col = segment.join_gather(
                flat(staged.blocks[src]), sections, staged.narrow_offsets.get(src),
                -1 if dt == DataType.STRING else 0,
            )
            parts += [col[:M], col[cap_m : cap_m + UR], col[cap_m + cap_r : cap_m + cap_r + UL]]
            if dt == DataType.STRING and (UR if side == 0 else UL):
                # A column with outer-null rows: each code's first row, for
                # the reference's numbering (_reencode_outer_nulls).
                d = (lt if side == 0 else rt).dictionaries[src]
                firsts[i] = _first_rows(torch.cat(parts[-3:]), len(d))
        host = _fetch(parts + list(firsts.values()))
        first_of = dict(zip(firsts, host[len(parts):]))
        data = {}
        for i, (side, src, out_name, dt) in enumerate(out_plan):
            a = np.concatenate(host[3 * i : 3 * i + 3])
            if dt != DataType.STRING:
                data[out_name] = a.astype(host_dtype(dt))
                continue
            codes = a.astype(np.int32)
            d = (lt if side == 0 else rt).dictionaries[src]
            if i in first_of:
                d, codes = _reencode_outer_nulls(codes, d, first_of[i])
            data[out_name] = DictColumn(codes, d)
        return RowBatch.from_pydict(m.out_relation, data, eow=True, eos=True)

    # -- the partitioned join (K15's rest) --------------------------------------
    def _try_partitioned_join(
        self, m: _JoinMatch, lt, rt, kl, kr, K: int, count_l, count_r, out_plan,
        key_space_sig: str, cols_l: set, cols_r: set, nl: int, nr: int,
        left_sel=None, right_sel=None,
    ) -> Optional[RowBatch]:
        """The sort-merge join over the hosts axis
        (pixie_tpu/parallel/pipeline.py:3426): both sides' rows go to one
        contiguous key range a host, the ranges balanced by each key's exact
        work (``count_l * count_r + count_l + count_r``: its pairs and the
        rows that move); each side stages shard-major (a stable permutation,
        so a host's rows keep their order; ``stage_partitioned``), each host
        sorts and merges its own range (``_run_partitioned_join``), and the
        host reorders the sections to the engine's emission order: the rows
        of the replicated lane and of the host EquijoinNode, in their order.
        Per-host pair and unmatched counts are exact, and every host's
        sections take the largest host's power-of-two caps. None (a side
        moved while staging, or no work at all) falls through to the
        replicated lane. The mesh is read once: another query may move the
        executor to another rung meanwhile, and every step of this one
        stays on the geometry it planned for. ``left_sel`` and ``right_sel``
        are the pushed-down predicates' row masks over each side's read
        (None: every row); ``kl``, ``kr``, ``nl`` and ``nr`` are of the
        selected rows."""
        mesh = self.mesh
        H = int(mesh.shape[0])
        work = count_l * count_r + count_l + count_r
        cum = np.cumsum(work)
        total_w = int(cum[-1]) if len(cum) else 0
        if total_w <= 0:
            return None
        how = m.join_op.how
        with timed("key_plan"):
            targets = (np.arange(1, H, dtype=np.int64) * total_w) // H
            bounds = np.searchsorted(cum, targets, side="left")
            key_shard = np.searchsorted(bounds, np.arange(K), side="right").astype(np.int32)
            shard_l, shard_r = key_shard[kl], key_shard[kr]
            perm_l = np.argsort(shard_l, kind="stable")
            perm_r = np.argsort(shard_r, kind="stable")
            rows_l = np.bincount(shard_l, minlength=H).astype(np.int64)
            rows_r = np.bincount(shard_r, minlength=H).astype(np.int64)
            m_s = np.zeros(H, np.int64)
            np.add.at(m_s, key_shard, count_l * count_r)
            ur_s = np.zeros(H, np.int64)
            np.add.at(ur_s, key_shard, np.where(count_l == 0, count_r, 0))
            ul_s = np.zeros(H, np.int64)
            np.add.at(ul_s, key_shard, np.where(count_r == 0, count_l, 0))
        caps = (
            _pow2_at_least(max(int(m_s.max()), 1)),
            _pow2_at_least(max(int(ur_s.max()), 1)) if how in (JoinType.RIGHT, JoinType.OUTER) else 0,
            _pow2_at_least(max(int(ul_s.max()), 1)) if how in (JoinType.LEFT, JoinType.OUTER) else 0,
        )
        ck_l, staged_l = self._stage_partitioned_side(
            mesh, lt, m.left_source_op, cols_l, kl, perm_l, rows_l, K, nl, key_space_sig, "L",
            left_sel)
        if staged_l is None:
            return None
        ck_r, staged_r = self._stage_partitioned_side(
            mesh, rt, m.right_source_op, cols_r, kr, perm_r, rows_r, K, nr, key_space_sig, "R",
            right_sel)
        if staged_r is None:
            return None
        segment.lane_count("join_partitioned")
        pool = self._staged_cache
        with pool.pin(ck_l), pool.pin(ck_r), timed("fold"):
            hosts = self._run_partitioned_join(
                mesh, staged_l, staged_r, out_plan, K, caps, (m_s, ur_s, ul_s))
        with timed("join_reorder"):
            # The device emits each host's pairs probe-row-major over its
            # permuted probe rows; the engine emits them probe-row-major over
            # the original probe order with each probe row's build matches
            # together, so a stable argsort of the emitted original probe
            # rows (each repeated by its fan-out) is the exact inverse.
            fan_r = count_l[kr[perm_r]]
            order_m = np.argsort(np.repeat(perm_r, fan_r), kind="stable")
            emit_r = perm_r[(count_l[kr] == 0)[perm_r]]
            order_r = np.argsort(emit_r, kind="stable")
            emit_l = perm_l[(count_r[kl] == 0)[perm_l]]
            order_l = np.argsort(emit_l, kind="stable")
            data = {}
            for i, (side, src, out_name, dt) in enumerate(out_plan):
                secs = [np.concatenate([h[3 * i] for h in hosts])[order_m]]
                if caps[1]:
                    secs.append(np.concatenate([h[3 * i + 1] for h in hosts])[order_r])
                if caps[2]:
                    secs.append(np.concatenate([h[3 * i + 2] for h in hosts])[order_l])
                a = np.concatenate(secs)
                if dt != DataType.STRING:
                    data[out_name] = a.astype(host_dtype(dt))
                    continue
                codes = a.astype(np.int32)
                d = (lt if side == 0 else rt).dictionaries[src]
                if (codes < 0).any():
                    # Outer-null rows: the replicated lane's numbering
                    # (Fault-9), each code's first row taken on the host.
                    first = np.full(len(d) + 1, np.iinfo(np.int64).max, np.int64)
                    np.minimum.at(first, codes.astype(np.int64) % (len(d) + 1),
                                  np.arange(len(codes), dtype=np.int64))
                    d, codes = _reencode_outer_nulls(codes, d, first)
                data[out_name] = DictColumn(codes, d)
        return RowBatch.from_pydict(m.out_relation, data, eow=True, eos=True)

    def _stage_partitioned_side(
        self, mesh, table, src_op, cols_needed: set, kk, perm, rows_s, K: int, n_expect: int,
        key_space_sig: str, tag: str, row_sel=None,
    ) -> tuple:
        """(cache key, staging) of one join side read, its rows selected by
        ``row_sel`` (a mask over the read, or None), permuted shard-major
        and staged by ``stage_partitioned`` (pixie_tpu/parallel/pipeline.py:
        3557), or (None, None) when the table moved under the read. Cached
        and registered in the residency pool under ``:meshjoin{tag}:{H}:``;
        an out-of-memory staging clears the pool and retries once, the
        reference's policy."""
        ck = self._staged_key(table, src_op, cols_needed,
                              f":meshjoin{tag}:{int(mesh.shape[0])}:" + key_space_sig, K)
        key, staged = self._staged_lookup(ck)
        if staged is not None and staged.num_rows == n_expect:
            return key, staged
        with timed("read_columns"):
            cols, n = read_columns(table, sorted(cols_needed), src_op.start_time,
                                   src_op.stop_time)
        if row_sel is not None:
            if len(row_sel) != n:
                return None, None
            cols = {c: np.asarray(a)[row_sel] for c, a in cols.items()}
            n = int(np.count_nonzero(row_sel))
        if n != n_expect or len(kk) != n:
            return None, None
        with timed("stage_host_pack"):
            cols = {c: np.asarray(a)[perm] for c, a in cols.items()}
            gids = kk[perm].astype(np.int32)
        with timed("stage"):
            try:
                staged = stage_partitioned(mesh, cols, gids, rows_s, K,
                                           block_rows=self.block_rows)
            except torch.OutOfMemoryError:
                self._staged_cache.clear(reason="oom")
                staged = stage_partitioned(mesh, cols, gids, rows_s, K,
                                           block_rows=self.block_rows)
        self._staged_insert(ck, staged)
        return ck, staged

    def _host_lane(self, lane, h: int, d_host: int) -> torch.Tensor:
        """Host h's shards of a staged lane as one flat tensor on host h's
        first device (the reference's all_gather over the inner axes): a
        view when the shards share a device (logical shards), else a peer
        copy of each to it."""
        lo, hi = h * d_host, (h + 1) * d_host
        if isinstance(lane, torch.Tensor):
            return lane[lo:hi].reshape(-1)
        dev = lane.parts[lo].device
        return torch.cat([lane.parts[s].reshape(-1).to(dev, non_blocking=True)
                          for s in range(lo, hi)])

    def _run_partitioned_join(
        self, mesh, staged_l, staged_r, out_plan, K: int, caps: tuple, counts: tuple,
    ) -> list:
        """Each host's sort-merge (pixie_tpu/parallel/pipeline.py:3615) on
        its first device: its inner shards' lanes concatenated there, the
        sentinels K (build padding) and K + 1 (probe padding; other hosts'
        keys never appear), ``segment.local_sort_merge`` (``torch.sort``,
        H13, cumsum, H14, H12) and H15 per output column into the sections
        [cap_m | cap_r | cap_l]. Every host's work is enqueued on its own
        device before any host waits, so cards overlap; then each host's
        sections cut to its exact counts come back in ONE device -> host
        copy a host. Returns, for each host, [matched, unmatched probe,
        unmatched build] of every output column, as numpy."""
        cap_m, cap_r, cap_l = caps
        m_s, ur_s, ul_s = counts
        H = int(mesh.shape[0])
        d_host = mesh.size // H
        packed = []
        for h in range(H):
            lane_l = lambda lane: self._host_lane(lane, h, d_host)  # noqa: E731
            lmask, rmask = lane_l(staged_l.mask), lane_l(staged_r.mask)
            lkey = torch.where(lmask, lane_l(staged_l.gids).to(torch.int32), K)
            rkey = torch.where(rmask, lane_l(staged_r.gids).to(torch.int32), K + 1)
            build_rows, probe_rows, _, ur, ul = segment.local_sort_merge(
                lkey, rkey, lmask, rmask, cap_m, cap_r, cap_l, K
            )
            parts = []
            M, UR, UL = int(m_s[h]), int(ur_s[h]), int(ul_s[h])
            for side, src, _, dt in out_plan:
                staged = staged_l if side == 0 else staged_r
                sections = (
                    [(build_rows, cap_m), (None, cap_r), (ul, cap_l)]
                    if side == 0
                    else [(probe_rows, cap_m), (ur, cap_r), (None, cap_l)]
                )
                col = segment.join_gather(
                    lane_l(staged.blocks[src]), sections, staged.narrow_offsets.get(src),
                    -1 if dt == DataType.STRING else 0,
                )
                parts += [col[:M], col[cap_m : cap_m + UR],
                          col[cap_m + cap_r : cap_m + cap_r + UL]]
            packed.append(_pack_bytes(parts))
        return [_unpack_bytes(*p) for p in _copy_to_host(packed)]

    # -- the join-aggregate lane (K17) -----------------------------------------
    def _try_execute_join_agg(
        self, fragment, relations, table_store, registry, func_ctx
    ) -> Optional[tuple[int, RowBatch]]:
        """(agg node id, the aggregate) for an INNER join that feeds a
        count/sum/mean/min/max group-by, else None
        (pixie_tpu/parallel/pipeline.py:2214). The gates are the
        reference's: ``match_join_agg``'s, bare-column join keys,
        single-argument aggregates, no STRING argument, at most 2^22 join-key
        ids (``_join_key_ids``: the reference's shared StringDictionary and
        GroupEncoder) and a group capacity of at most 2^20. One gate is the
        port's: a UINT128 argument (staging has no 128-bit lane). One
        reference gate is not kept: a ``count`` whose argument is a right
        column, which the reference's right pass declines though the count
        needs no right statistic (ROADMAP Fault-8); the port takes the lane,
        with the same result. The right side reduces to per-key statistics
        (``_run_right_stats``), the left side folds once with per-row
        weights (``_run_left_join_agg``); the pairs are never built."""
        m = match_join_agg(fragment, relations)
        if m is None:
            return None
        lt = table_store.get_table(m.left_source_op.table_name)
        rt = table_store.get_table(m.right_source_op.table_name)
        if lt is None or rt is None:
            return None
        if not all(isinstance(e, ColumnRef) for e in m.left_key_exprs + m.right_key_exprs):
            return None
        for (_, agg), (_o, side, arg_e, _n) in zip(m.agg_op.values, m.specs):
            if len(agg.args) != 1:
                return None  # single-argument decompositions only
            rel = m.left_relation if side == 0 else m.right_relation
            try:
                dt = expr_data_type(arg_e, rel, registry)
            except (KeyError, ValueError):
                return None
            if dt in (DataType.STRING, DataType.UINT128):
                return None
        lsrc, rsrc = m.left_source_op, m.right_source_op
        with timed("read_columns"):
            lcols, nl = read_columns(
                lt, sorted({e.name for e in m.left_key_exprs}), lsrc.start_time, lsrc.stop_time
            )
            rcols, nr = read_columns(
                rt, sorted({e.name for e in m.right_key_exprs}), rsrc.start_time, rsrc.stop_time
            )
        with timed("key_plan"):
            kl, kr, K = self._join_key_ids(m, lt, rt, lcols, rcols)
        if kl is None or K > (1 << 22):
            return None
        # The group-key plan over the LEFT side.
        shim = _Match(
            source_nid=m.left_source_nid,
            agg_nid=m.agg_nid,
            source_op=lsrc,
            agg_op=dataclasses.replace(m.agg_op, groups=tuple(g for g, _ in m.group_exprs)),
            col_exprs={g: e for g, e in m.group_exprs},
            predicates=[],
            source_relation=m.left_relation,
        )
        key_plan = self._plan_keys(shim, lt, registry, func_ctx, set())
        if key_plan is None:
            return None
        if m.group_exprs and key_plan.host_gids is None:
            # _plan_keys takes a dictionary key's codes (or a LUT key's
            # per-code gids) as device gids; the fold stages host gids, read
            # from the same dictionary structures
            # (pixie_tpu/parallel/pipeline.py:2296-2321).
            if isinstance(key_plan.device_expr, ColumnRef):
                name, lut = key_plan.device_expr.name, None
            else:
                _, name, lut = key_plan.device_expr
            codes, _ = read_columns(lt, [name], lsrc.start_time, lsrc.stop_time)
            gids = codes[name] if lut is None else np.asarray(lut)[np.maximum(codes[name], 0)]
            key_plan = dataclasses.replace(key_plan, host_gids=gids.astype(np.int32))
        if key_plan.host_gids is None:
            # Group-by-none: one group, still staged as a gid lane (:2324-2329).
            key_plan = dataclasses.replace(
                key_plan, host_gids=np.zeros(nl, np.int32), num_groups=1
            )
        if len(key_plan.host_gids) != nl:
            return None
        capacity = _pow2_at_least(max(key_plan.num_groups, 1))
        if capacity > (1 << 20):
            return None
        # A count reads no argument: __count__, the weighted row count,
        # serves every count spec of either side.
        right_specs = [(o, e, name) for o, side, e, name in m.specs
                       if side == 1 and name != "count"]
        r_preds = m.right_preds + m.post_right_preds
        l_preds = m.left_preds + m.post_left_preds
        try:
            r_eval = ExpressionEvaluator(
                [(f"pred{i}", p) for i, p in enumerate(r_preds)]
                + [(f"arg:{o}", e) for o, e, _ in right_specs],
                m.right_relation, registry, func_ctx, device=self.device,
            )
            l_eval = ExpressionEvaluator(
                [(f"pred{i}", p) for i, p in enumerate(l_preds)]
                + [(f"arg:{o}", e) for o, side, e, name in m.specs
                   if side == 0 and name != "count"],
                m.left_relation, registry, func_ctx, device=self.device,
            )
        except ValueError:
            return None
        # Left keys encode first, so the right side's ids depend on the left
        # table too: the right staging's identity pins the whole key space.
        key_space_sig = repr((
            lsrc.table_name, (lt.min_row_id(), lt.end_row_id()),
            repr(m.left_key_exprs) + repr(m.right_key_exprs),
            lsrc.start_time, lsrc.stop_time,
        ))
        rstats = self._run_right_stats(m, rt, kr, nr, K, r_eval, right_specs, key_space_sig)
        if rstats is None:
            return None
        batch = self._run_left_join_agg(m, lt, kl, nl, key_plan, capacity, l_eval, rstats, registry)
        if batch is None:
            return None
        segment.lane_count("join_agg")
        return m.agg_nid, batch

    def _join_program(self, evaluator, table, relation):
        """(program, aux) of a join lane's side: its predicates into the
        block mask and each argument as an f64 column ``arg:<out>``; None
        when a tree cannot run on the device."""
        preds = [e for n, e in evaluator.named_exprs if n.startswith("pred")]
        roots = [(n, e, torch.float64, None) for n, e in evaluator.named_exprs
                 if n.startswith("arg:")]
        return self._compile(evaluator, table, relation, roots, preds)

    def _run_right_stats(self, m, table, kr, nr, K, evaluator, right_specs, key_space_sig):
        """Stage the right side with its join-key ids as the gids and reduce
        per-key statistics (pixie_tpu/parallel/pipeline.py:2402): nR, the
        match count of each key, through H1 as an int64 count (exact in
        f64); each right sum/mean argument's sum through H2; each min/max
        through H11, in place on a state of +-inf identities, which is the
        reference's jnp.minimum(acc, seg_min(...)) merge under Fault-5. Each
        shard reduces its rows; the shards' statistics merge at the root.
        Returns (nR f64 [K], {(kind, out name): f64 [K]}) on the root, or
        None when the table moved since its keys were read."""
        base: set = set()
        for _, e in evaluator.named_exprs:
            base |= referenced_columns(e)
        compiled = self._join_program(evaluator, table, m.right_relation)
        if compiled is None:
            return None
        program, aux = compiled
        key, staged = self._stage_cached(
            table, m.right_source_op, base, ":joinright:" + key_space_sig, K, gids=kr
        )
        if staged.num_rows != nr:
            return None
        kinds = [(o, "sum" if name in ("sum", "mean") else name) for o, _, name in right_specs]
        shard_leaves = []
        with self._staged_cache.pin(key), timed("fold"):
            for s, a in enumerate(self._replicate(aux)):
                sv, dev = staged.shard(s), staged.shard_device(s)
                counts = torch.zeros(K, dtype=torch.int64, device=dev)
                stats = []
                for o, kind in kinds:
                    if kind == "sum":
                        stats.append(torch.zeros(K, dtype=torch.float64, device=dev))
                    else:
                        ident = float("inf") if kind == "min" else float("-inf")
                        stats.append(torch.full((K,), ident, dtype=torch.float64, device=dev))
                for blk in range(sv.num_blocks):
                    vals = self._run_block(program, sv, blk, a)
                    mask = vals["__mask__"]
                    jk = sv.gids[0, blk].to(torch.int32)
                    counts += segment.seg_count(jk, K, mask)
                    for (o, kind), st in zip(kinds, stats):
                        val = vals[f"arg:{o}"].contiguous()
                        if kind == "sum":
                            st += segment.seg_sum(val, jk, K, mask)
                        else:
                            segment.segment_minmax(st, val, jk, mask, kind == "min")
                shard_leaves.append([counts] + stats)
            # The shards' statistics merge at the root (K18: psum, pmin,
            # pmax; pixie_tpu/parallel/pipeline.py:2533-2536).
            merged = merge.merge_leaves(
                shard_leaves, ["sum"] + [kind for _, kind in kinds], self.device
            )
        stats = {(kind, o): st for (o, kind), st in zip(kinds, merged[1:])}
        return merged[0].to(torch.float64), stats

    def _run_left_join_agg(
        self, m, table, kl, nl, key_plan, capacity, evaluator, rstats, registry
    ) -> Optional[RowBatch]:
        """Fold the LEFT side once with per-row weights w = nR[jk]
        (pixie_tpu/parallel/pipeline.py:2588): per block, H16 adds the
        join's count, the weighted left sums and the gathered right sums of
        every group and writes the effective mask (mask & w > 0), under
        which H11 folds the left min/max arguments and the right minR/maxR
        gathered by join key. Each shard folds its rows; the shards' folds
        merge at the root; ONE device -> host copy, then the reference's
        finalize: groups with a count, mean = sum / max(count, 1), integer
        outputs the f64 result rounded and cast (so an INT64 sum over a join
        goes through f64, as in the reference)."""
        n_right, rstat = rstats
        compiled = self._join_program(evaluator, table, m.left_relation)
        if compiled is None:
            return None
        program, aux = compiled
        base: set = set()
        for _, e in evaluator.named_exprs:
            base |= referenced_columns(e)
        key, staged = self._stage_cached(
            table, m.left_source_op, base,
            ":joinleft:" + repr(m.left_key_exprs) + repr([e for _, e in m.group_exprs]),
            key_plan.num_groups, gids=key_plan.host_gids,
            extra_cols={"__jk__": kl.astype(np.int32)},
        )
        if staged.num_rows != nl:
            return None
        sums_l = [o for o, side, _, name in m.specs if side == 0 and name in ("sum", "mean")]
        sums_r = [o for o, side, _, name in m.specs if side == 1 and name in ("sum", "mean")]
        extremes = [(o, side, name) for o, side, _, name in m.specs if name in ("min", "max")]
        K = n_right.shape[0]
        root = {
            "n_right": n_right,
            "right_sums": (
                torch.stack([rstat[("sum", o)] for o in sums_r]) if sums_r
                else torch.empty((0, K), dtype=torch.float64, device=self.device)
            ),
        }
        root.update({f"r:{o}": rstat[(name, o)] for o, side, name in extremes if side == 1})
        shard_leaves = []
        with self._staged_cache.pin(key), timed("fold"):
            for s, (a, rs) in enumerate(zip(self._replicate(aux), self._replicate(root))):
                sv, dev = staged.shard(s), staged.shard_device(s)
                acc = torch.zeros((1 + len(sums_l) + len(sums_r), capacity), dtype=torch.float64,
                                  device=dev)
                ext = [
                    torch.full((capacity,), float("inf") if name == "min" else float("-inf"),
                               dtype=torch.float64, device=dev)
                    for _, _, name in extremes
                ]
                for blk in range(sv.num_blocks):
                    vals = self._run_block(program, sv, blk, a)
                    mask = vals["__mask__"]
                    # H16 reads the join keys and gids as staged: one device
                    # operation a block for the call.
                    jk = sv.blocks["__jk__"][0, blk]
                    if "__jk__" in sv.narrow_offsets:
                        jk = segment.Narrow(jk, sv.narrow_offsets["__jk__"])
                    gids = sv.gids[0, blk]
                    eff = (torch.empty(mask.shape[0], dtype=torch.bool, device=dev)
                           if extremes else None)
                    segment.join_agg_fold(jk, gids, mask, rs["n_right"],
                                          [vals[f"arg:{o}"] for o in sums_l],
                                          rs["right_sums"], acc, eff)
                    if extremes:
                        gids = gids.to(torch.int32)
                    for (o, side, name), st in zip(extremes, ext):
                        if side == 0:
                            val = vals[f"arg:{o}"].contiguous()
                        else:
                            val = rs[f"r:{o}"][segment.widen(jk).long()]
                        segment.segment_minmax(st, val, gids, eff, name == "min")
                shard_leaves.append([acc] + ext)
            # The shards' folds merge at the root (K18: the count and sums
            # psum, min/max pmin/pmax; pixie_tpu/parallel/pipeline.py:2756-2766).
            merged = merge.merge_leaves(
                shard_leaves, ["sum"] + [name for _, _, name in extremes], self.device
            )
            host = _fetch(merged)
        counts = host[0][0]
        vals = {o: host[0][1 + i] for i, o in enumerate(sums_l)}
        vals.update({o: host[0][1 + len(sums_l) + j] for j, o in enumerate(sums_r)})
        vals.update({o: host[1 + i] for i, (o, _, _) in enumerate(extremes)})
        n = max(key_plan.num_groups, 1) if m.agg_op.groups else 1
        keep = counts[:n] > 0 if m.agg_op.groups else np.ones(1, dtype=bool)
        idx = np.nonzero(keep)[0]
        rel = m.agg_op.output_relation([self._join_pre_agg_relation(m, registry)], registry)
        out_cols: list = [
            col.take(idx) if isinstance(col, DictColumn) else np.asarray(col)[keep]
            for col in key_plan.key_columns
        ]
        for out_name, _side, _e, name in m.specs:
            if name == "count":
                out = counts[:n][keep]
            elif name == "mean":
                out = vals[out_name][:n][keep] / np.maximum(counts[:n][keep], 1.0)
            else:
                out = vals[out_name][:n][keep]
            dt = host_dtype(rel.col(out_name).data_type)
            out_cols.append(
                np.round(out).astype(dt) if np.issubdtype(dt, np.integer) else out.astype(dt)
            )
        return RowBatch(rel, out_cols, eow=True, eos=True)

    @staticmethod
    def _join_pre_agg_relation(m: _JoinAggMatch, registry) -> Relation:
        """The relation the agg's output resolution expects: the group
        columns (left source terms), then each post-join argument column
        typed by its side (pixie_tpu/parallel/pipeline.py:2846)."""
        cols, seen = [], set()
        for g, e in m.group_exprs:
            cols.append(ColumnSchema(g, expr_data_type(e, m.left_relation, registry)))
            seen.add(g)
        for out_name, agg in m.agg_op.values:
            for ref in referenced_columns(agg):
                if ref in seen:
                    continue
                for o, side, arg_e, _n in m.specs:
                    if o == out_name:
                        rel = m.left_relation if side == 0 else m.right_relation
                        try:
                            dt = expr_data_type(arg_e, rel, registry)
                        except (KeyError, ValueError):
                            dt = DataType.FLOAT64
                        cols.append(ColumnSchema(ref, dt))
                        seen.add(ref)
                        break
        return Relation(cols)

    # -- staged-column cache -------------------------------------------------
    def _staged_lookup(self, cache_key) -> tuple:
        """(the key of the entry found, the entry), or (cache_key, None).
        Keys name the executor's device tuple and every rung of the
        degradation ladder is built over it, so an entry's shards already
        sit where the current mesh puts them (the reference re-places a
        staging here; the port never has to)."""
        staged = self._staged_cache.get(cache_key)
        if staged is None:
            # Superset reuse: an entry staged for a wider column set of the
            # same table version/window/key plan serves this query.
            for k, v in self._staged_cache.items():
                if (
                    k[:2] == cache_key[:2]
                    and set(k[2]) >= set(cache_key[2])
                    and k[3:] == cache_key[3:]
                ):
                    cache_key, staged = k, v
                    self._staged_cache.touch(k)
                    break
        devices = getattr(staged, "devices", ())
        assert not devices or tuple(devices) == tuple(self.mesh.devices), (
            "a staged entry on other devices than the mesh's"
        )
        return cache_key, staged

    def _staged_insert(self, cache_key, staged) -> None:
        """Register a staging with the pool, which supersedes the older
        versions of the same table (they can never hit again) and enforces
        the entry cap and the byte watermarks."""
        table_name, version = cache_key[:2]
        self._staged_cache.insert(cache_key, staged, table_name, version)

    def _staged_key(
        self, table, source_op, base_cols: set, key_sig: str, num_groups: int,
        f32_cols: Optional[set] = None, cell_cols: Optional[dict] = None,
    ) -> tuple:
        """The staged-column cache key of this table version and window.
        ``key_sig`` pins what the staging serves (the group expressions, or
        ``":scan"``); the f32 sketch columns and the int-dictionary cell
        columns (name and cardinality bound) are part of it, so an exact
        query never reuses a column staged as f32 or as sketch codes
        (pixie_tpu/parallel/pipeline.py:2029-2032)."""
        return (
            source_op.table_name,
            # Version = (min_row_id, end_row_id): writes bump end_row_id and
            # ring-buffer expiry bumps min_row_id, so either invalidates.
            (table.min_row_id(), table.end_row_id()),
            tuple(sorted(base_cols)),
            source_op.start_time,
            source_op.stop_time,
            self.block_rows,
            key_sig,
            num_groups,
            tuple(sorted(f32_cols or ())),
            tuple(sorted((cell_cols or {}).items())),
            self._mesh_key,
        )

    def _stage_cached(
        self, table, source_op, base_cols: set, key_sig: str, num_groups: int,
        gids: Optional[np.ndarray] = None, extra_cols: Optional[dict] = None,
        row_sel: Optional[np.ndarray] = None,
    ) -> tuple:
        """(cache key, the staged columns) of this table version and window,
        staged in one piece (with the codec) and cached on a miss: the scan,
        join and join-aggregate lanes. With no ``extra_cols`` and no
        ``row_sel`` a table with a resident ring assembles its staging from
        the ring's windows and the staged tail (``_try_resident_assemble``).
        ``extra_cols`` are host columns of the table's rows staged beside the
        read ones (the join-aggregate lane's join-key ids), pinned by
        ``key_sig``. ``row_sel`` is a mask over the read (the join's
        pushed-down predicates, pinned by ``key_sig``'s digests): the rows
        it keeps stage, in row order, and ``gids`` are theirs. The staging
        is None when the table moved under the mask (pixie_tpu/parallel/
        pipeline.py:3940-3973)."""
        cache_key = self._staged_key(table, source_op, base_cols, key_sig, num_groups)
        key, staged = self._staged_lookup(cache_key)
        if staged is None:
            base_row = table.min_row_id()
            with timed("read_columns"):
                cols, n = read_columns(
                    table, sorted(base_cols), source_op.start_time, source_op.stop_time
                )
            if row_sel is not None:
                if len(row_sel) != n:
                    return cache_key, None
                cols = {c: np.asarray(a)[row_sel] for c, a in cols.items()}
                n = int(np.count_nonzero(row_sel))
            cols.update(extra_cols or {})
            with timed("stage"):
                if not extra_cols and row_sel is None:
                    staged = self._try_resident_assemble(
                        table, source_op, cols, n, gids, num_groups, base_row
                    )
                if staged is None:
                    staged = stage_columns(
                        cols, n, self.mesh.devices, block_rows=self.block_rows, gids=gids,
                        num_groups=num_groups,
                    )
            self._staged_insert(cache_key, staged)
            key = cache_key
        return key, staged

    def _stage_monolithic(
        self, cols: dict, n: int, key_plan: _KeyPlan, f32_cols: set, cell_cols: dict
    ) -> StagedColumns:
        """The aggregate lane's staging in one piece: the cell columns whose
        value set fits their bound replaced by codes (``int_dict_encode``),
        then ``stage_columns``."""
        int_dicts = {}
        with timed("int_dict_encode"):
            for col, max_card in cell_cols.items():
                enc = int_dict_encode(cols[col], max_card)
                if enc is not None:
                    cols[col], int_dicts[col] = enc
        with timed("stage"):
            return stage_columns(
                cols, n, self.mesh.devices, block_rows=self.block_rows, f32_cols=f32_cols,
                gids=key_plan.host_gids, num_groups=key_plan.num_groups, int_dicts=int_dicts,
            )

    def _with_intdicts(self, aux: dict, staged: StagedColumns) -> dict:
        """``aux`` plus each int-dictionary column's value LUT on the device,
        ``intdict:<col>`` (pixie_tpu/parallel/pipeline.py:2100-2107)."""
        if not staged.int_dicts:
            return aux
        out = dict(aux)
        for col, lut in staged.int_dicts.items():
            out[f"intdict:{col}"] = torch.as_tensor(np.asarray(lut, np.int64), device=self.device)
        return out

    @staticmethod
    def _block_env(staged: StagedColumns, blk: int, names=None, keep=frozenset()) -> dict:
        """Block ``blk``'s columns (``names``, or all of them), the narrowed
        ints widened back to int64 (torch has no arithmetic on uint16) but
        those in ``keep``, which stay as staged."""
        names = staged.blocks if names is None else names
        env = {name: staged.blocks[name][0, blk] for name in names}
        for name in env:
            if name in staged.narrow_offsets and name not in keep:
                env[name] = env[name].to(torch.int64) + staged.narrow_offsets[name]
        return env

    def _run_block(self, program, staged: StagedColumns, blk: int, aux,
                   keep=frozenset()) -> dict:
        """One block through its H17 program: {result name: [n] tensor}, the
        block's mask (``__mask__``) among them. The program reads the staged
        columns as they are (H17 widens a narrowed int on load); only the
        columns a passthrough hands on are widened here, but those in
        ``keep`` (``_staged_args``), handed on as staged."""
        valid = staged.mask[0, blk]
        raw = {c: staged.blocks[c][0, blk] for c in program.columns if c in staged.blocks}
        raw["__valid__"] = valid
        env = self._block_env(
            staged, blk, [c for c in program.passthrough_names() if c in staged.blocks], keep
        )
        env["__valid__"] = valid
        return program.run(env, aux, staged.block_rows, raw=raw, offsets=staged.narrow_offsets)

    # -- planning ------------------------------------------------------------
    def _agg_specs(self, m: _Match, registry):
        """[(out_name, source-term arg expr, uda)] or None when an aggregate
        is outside the slice."""
        specs = []
        for out_name, agg in m.agg_op.values:
            arg_exprs = [substitute(a, m.col_exprs) for a in agg.args]
            try:
                types = [
                    expr_data_type(a, m.source_relation, registry) for a in arg_exprs
                ]
            except (KeyError, ValueError):
                return None
            uda = registry.lookup_uda(agg.name, types)
            if uda is None:
                return None
            if not uda.reads_args:
                specs.append((out_name, arg_exprs[0], uda))
                continue
            if len(arg_exprs) != 1:
                return None  # multi-arg UDAs: not in the slice
            if types[0] == DataType.STRING and (
                uda.string_args == "values"  # needs decoded strings: the host's
                or (
                    # A code-valued state (any) decodes through, and a
                    # string-hash argument gathers its content hashes from,
                    # the table dictionary: only a bare source column has one.
                    (uda.string_args == "hash" or uda.string_state)
                    and not isinstance(arg_exprs[0], ColumnRef)
                )
            ):
                return None
            specs.append((out_name, arg_exprs[0], uda))
        return specs

    def _make_evaluator(self, m: _Match, specs, registry, func_ctx):
        named = [(f"pred{i}", p) for i, p in enumerate(m.predicates)]
        for out_name, arg_e, uda in specs:
            if uda.reads_args:
                named.append((f"arg:{out_name}:0", arg_e))
        for g in m.agg_op.groups:
            named.append((f"key:{g}", m.col_exprs[g]))
        try:
            return ExpressionEvaluator(named, m.source_relation, registry, func_ctx,
                                       device=self.device)
        except ValueError:
            return None

    def _plan_keys(self, m: _Match, table, registry, func_ctx, base_cols: set):
        """No key: one group. One bare string column with a dictionary: its
        codes are the gids, evaluated on the device. One string key computed
        by a dict_compatible host function of one dictionary column
        (``_dict_lut_key``): per-code gids through a LUT on the device
        (device_expr ``("lut", column, lut)``). Any other key: densified on
        the host (``_host_key_plan``)."""
        groups = m.agg_op.groups
        if not groups:
            return _KeyPlan(device_expr=None, num_groups=1, key_columns=[])
        if len(groups) == 1:
            e = m.col_exprs[groups[0]]
            try:
                t = expr_data_type(e, m.source_relation, registry)
            except (KeyError, ValueError):
                return None
            d = table.dictionaries.get(e.name) if isinstance(e, ColumnRef) else None
            if t == DataType.STRING and d is not None:
                base_cols.add(e.name)
                return _KeyPlan(
                    device_expr=e,
                    num_groups=len(d),
                    key_columns=[DictColumn(np.arange(len(d), dtype=np.int32), d)],
                )
            lut = self._dict_lut_key(e, table, registry, func_ctx, self.device) if t == DataType.STRING else None
            if lut is not None:
                lut_codes, out_dict, src = lut
                base_cols.add(src)
                return _KeyPlan(
                    device_expr=("lut", src, lut_codes),
                    num_groups=len(out_dict),
                    key_columns=[DictColumn(np.arange(len(out_dict), dtype=np.int32), out_dict)],
                )
        return self._host_key_plan(m, table, registry, func_ctx)

    @staticmethod
    def _dict_lut_key(e, table, registry, func_ctx=None, device=None):
        """(per-code gids int32, the key's dictionary, source column) for a
        string key computed by a dict_compatible HOST function of one
        dictionary column and constants (the ``ctx['service']`` and
        ``regex_replace(..., req_path, ...)`` shapes): the function runs
        once per dictionary value and its results are encoded in that order
        (pixie_tpu/parallel/pipeline.py:4617-4648); None for any other key."""
        if not isinstance(e, FuncCall):
            return None
        str_cols = [a for a in e.args if isinstance(a, ColumnRef)]
        if len(str_cols) != 1 or not all(isinstance(a, (ColumnRef, Constant)) for a in e.args):
            return None
        src = str_cols[0].name
        d = table.dictionaries.get(src)
        if d is None:
            return None
        arg_types = [DataType.STRING if isinstance(a, ColumnRef) else a.data_type for a in e.args]
        udf = registry.lookup_scalar(e.name, arg_types)
        if udf is None or udf.executor != Executor.HOST or not udf.dict_compatible:
            return None
        values = np.asarray(d.values(), dtype=object)
        fn_args = [values if isinstance(a, ColumnRef) else a.value for a in e.args]
        fn_args += list(e.init_args)
        per_value = np.asarray(call_host(udf, fn_args, func_ctx, device), dtype=object)
        out_dict = StringDictionary()
        return out_dict.encode(per_value).astype(np.int32), out_dict, src

    def _host_key_plan(self, m: _Match, table, registry, func_ctx) -> _KeyPlan:
        """Evaluate the key exprs over the table once, per cursor batch, and
        densify them with one GroupEncoder (gids in its first-seen order),
        as pixie_tpu/parallel/pipeline.py:4524 does; cached per table
        version + key exprs + time window. (The reference does not cache a
        key that calls a metadata-state function; the port has none yet.)"""
        groups = m.agg_op.groups
        kp_key = (
            m.source_op.table_name,
            (table.min_row_id(), table.end_row_id()),
            repr([m.col_exprs[g] for g in groups]),
            m.source_op.start_time,
            m.source_op.stop_time,
        )
        with self._cache_lock:
            cached = self._keyplan_cache.get(kp_key)
            if cached is not None:
                self._keyplan_cache.move_to_end(kp_key)
                return cached
        key_refs: set = set()
        for g in groups:
            key_refs |= referenced_columns(m.col_exprs[g])
        sub_names = [c for c in m.source_relation.col_names() if c in key_refs]
        sub_rel = m.source_relation.select(sub_names)
        ev = ExpressionEvaluator(
            [(g, m.col_exprs[g]) for g in groups], sub_rel, registry, func_ctx,
            device=self.device,
        )
        out_rel = MapOp(
            tuple((g, m.col_exprs[g]) for g in groups)
        ).output_relation([sub_rel], registry)
        enc = GroupEncoder()
        gid_parts: list = []
        # Bare string columns keep the table's dictionary, so their codes are
        # stable across batches; computed string keys get a fresh dictionary
        # per batch and are re-encoded through one stable dictionary.
        stable_dicts: dict = {}
        out_dicts: dict = {}
        with timed("key_plan"):
            cur = table.cursor(m.source_op.start_time, m.source_op.stop_time)
            while not cur.done():
                b = cur.next_batch()
                if b is None:
                    break
                if not b.num_rows:
                    continue
                key_batch = ev.evaluate(b.select(sub_names), out_rel)
                key_cols = []
                for g, col in zip(groups, key_batch.columns):
                    if isinstance(col, DictColumn):
                        if isinstance(m.col_exprs[g], ColumnRef):
                            out_dicts[g] = col.dictionary
                        else:
                            d = stable_dicts.setdefault(g, StringDictionary())
                            col = DictColumn(d.encode(col.decode()), d)
                            out_dicts[g] = d
                    key_cols.append(col)
                gid_parts.append(enc.encode(key_cols))
        gids = np.concatenate(gid_parts) if gid_parts else np.empty(0, np.int32)
        key_columns = []
        for g, arr in zip(groups, enc.key_arrays() or [[] for _ in groups]):
            arr = np.asarray(arr)
            key_columns.append(
                DictColumn(arr.astype(np.int32), out_dicts[g]) if g in out_dicts else arr
            )
        kp = _KeyPlan(host_gids=gids, num_groups=enc.num_groups, key_columns=key_columns)
        # Plans of older versions of the same table can never hit again.
        with self._cache_lock:
            for k in [
                k for k in self._keyplan_cache
                if k[0] == m.source_op.table_name and k[1] != kp_key[1]
            ]:
                del self._keyplan_cache[k]
            self._keyplan_cache[kp_key] = kp
            while len(self._keyplan_cache) > max(self._keyplan_cache_cap, 1):
                self._keyplan_cache.popitem(last=False)
        return kp

    def _plan_host_any(self, m: _Match, specs, key_plan: _KeyPlan, table) -> dict:
        """any() with no predicate needs ONE representative per group: the
        first row of the group in row order, from the key plan's host gids
        (or the dictionary key's codes) in one vectorized pass on the host
        (pixie_tpu/parallel/pipeline.py:4328). {out_name: per-group array
        (codes for strings)}, cached per (table version, window, keys,
        column); {} when no gid source is usable, which sends the column
        back to the device lane, and for a PARTIAL fold (its states cross
        the bridge)."""
        if m.predicates or m.agg_op.stage != AggStage.FULL:
            return {}
        num_groups = max(key_plan.num_groups, 1)
        gids = key_plan.host_gids
        gid_col = None
        if gids is None:
            if not isinstance(key_plan.device_expr, ColumnRef):
                return {}
            gid_col = key_plan.device_expr.name
        out = {}
        for out_name, arg_e, uda in specs:
            if not (uda.name == "any" and uda.reads_args and isinstance(arg_e, ColumnRef)):
                continue
            ck = (
                m.source_op.table_name,
                (table.min_row_id(), table.end_row_id()),
                m.source_op.start_time,
                m.source_op.stop_time,
                repr([m.col_exprs[g] for g in m.agg_op.groups]),
                arg_e.name,
            )
            with self._cache_lock:
                rep = self._hostany_cache.get(ck)
                if rep is not None:
                    self._hostany_cache.move_to_end(ck)
            if rep is None:
                want = sorted({arg_e.name} | ({gid_col} if gid_col else set()))
                cols, n = read_columns(
                    table, want, m.source_op.start_time, m.source_op.stop_time
                )
                g = gids if gids is not None else np.maximum(cols[gid_col], 0)
                if len(g) != n or n == 0 or int(g.max()) >= num_groups:
                    return {}  # the table moved under the key plan
                vals = cols[arg_e.name]
                rep = np.zeros(num_groups, vals.dtype)
                # Reversed assignment: the last write per gid wins, which is
                # the first occurrence in row order.
                rep[g[::-1]] = vals[::-1]
                with self._cache_lock:
                    self._hostany_cache[ck] = rep
                    while len(self._hostany_cache) > 32:
                        self._hostany_cache.popitem(last=False)
            out[out_name] = rep
        return out

    def _windowize_key_plan(self, m: _Match, table, key_plan: _KeyPlan, base_groups: int):
        """(the key plan with gid' = wid * G + gid, n_windows), or None
        (pixie_tpu/parallel/pipeline.py:4269-4327). The window ids come from
        the cursor's end-of-window markers (``read_columns_windowed``); the
        per-row gids are the host plan's, else materialized from the table
        as the reference does: zeros for group-by-none, a dictionary key's
        codes, a LUT key's per-code gids. Declines above 2^22 slots (the
        state tensors would be unreasonable) and when the table moved
        between the reads."""
        _, n, wids, n_windows = read_columns_windowed(
            table, [], m.source_op.start_time, m.source_op.stop_time
        )
        if n_windows * base_groups > (1 << 22):
            return None
        gids = key_plan.host_gids
        if gids is None:
            if key_plan.device_expr is None:
                gids = np.zeros(n, np.int32)
            else:
                if isinstance(key_plan.device_expr, ColumnRef):
                    src, lut = key_plan.device_expr.name, None
                else:
                    _, src, lut = key_plan.device_expr
                cols, n2 = read_columns(
                    table, [src], m.source_op.start_time, m.source_op.stop_time
                )
                if n2 != n:
                    return None
                codes = np.maximum(cols[src], 0)
                gids = codes if lut is None else np.asarray(lut)[codes]
        if len(gids) != n or len(wids) != n:
            return None
        combined = wids * base_groups + gids.astype(np.int64)
        return dataclasses.replace(
            key_plan, host_gids=combined.astype(np.int32), device_expr=None,
            num_groups=n_windows * base_groups,
        ), n_windows

    def _sketch_f32_cols(self, m: _Match, specs) -> set:
        """FLOAT64 source columns read ONLY as bare args of f32-grained
        sketch UDAs: staging them as f32 halves their bytes and changes no
        result (the sketch bins in f32)."""
        f64_cols = {
            c.name for c in m.source_relation if c.data_type == DataType.FLOAT64
        }
        blocked = set()
        for e in m.predicates:
            blocked |= referenced_columns(e)
        for g in m.agg_op.groups:
            blocked |= referenced_columns(m.col_exprs[g])
        out = set()
        for col in f64_cols - blocked:
            consumers = [
                (arg_e, uda)
                for _, arg_e, uda in specs
                if uda.reads_args and col in referenced_columns(arg_e)
            ]
            if consumers and all(
                isinstance(arg_e, ColumnRef) and uda.stage_f32_ok
                for arg_e, uda in consumers
            ):
                out.add(col)
        return out

    @staticmethod
    def _host_aux(evaluator, table, specs=(), key_plan=None) -> dict:
        """String-constant codes and dict-func LUTs of the predicates and
        args, the content-hash LUT ``arghash:<col>`` of each string-hash UDA
        over a bare dictionary column (pixie_tpu/parallel/pipeline.py:
        4652-4670) and a LUT key's per-code gids ``keylut``, as host arrays.
        Raises ValueError where a host function cannot become a table (a
        string-producing one)."""
        aux: dict[str, np.ndarray] = {}
        for out, arg_e, uda in specs:
            if uda.reads_args and uda.string_args == "hash" and isinstance(arg_e, ColumnRef):
                d = table.dictionaries.get(arg_e.name)
                if d is not None:
                    aux[f"arghash:{arg_e.name}"] = d.content_hashes().view(np.int64)
        if key_plan is not None and isinstance(key_plan.device_expr, tuple):
            aux["keylut"] = key_plan.device_expr[2]
        for name, e in evaluator.named_exprs:
            if not name.startswith("key:"):
                aux.update(evaluator.build_aux(e, table.dictionaries))
        return aux

    def _compile(self, evaluator, table, relation, roots, preds, specs=(), key_plan=None,
                 host_aux: Optional[dict] = None):
        """(H17 program, aux on the device) of one fragment's block trees, or
        None when a tree cannot run on the device: a host function without a
        table, a string-producing host function, an unknown function or a
        tree deeper than H17's register file. The reference's device lane
        fails on the same trees and its fragment runs on the host engine;
        here the gate sends the fragment to the host graph before anything
        is staged. ``host_aux``: a dict to fill with the aux's host arrays
        (``_host_aux``), or the arrays an earlier call filled in."""
        dtypes = _register_dtypes(relation)
        try:
            if not host_aux:
                fresh = self._host_aux(evaluator, table, specs, key_plan)
                if host_aux is not None:
                    host_aux.update(fresh)
            aux = {
                k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in (host_aux or fresh).items()
            }
            program = evaluator.compile_program(roots, dtypes, aux, mask=("__valid__", preds))
        except ValueError:
            return None
        return program, aux

    def _pass_plan(self, specs, num_groups: int) -> tuple[int, int]:
        """(per-pass capacity, n_passes): bound UDA state memory for
        high-cardinality group-bys; each pass folds every block for one
        contiguous gid window (pixie_tpu/parallel/pipeline.py:4719)."""
        per_group = 8  # presence counter
        for _, _, uda in specs:
            per_group += _state_bytes(uda.init(1, "cpu"))
        budget = flags.device_group_state_budget_mb * (1 << 20)
        cap_full = _pow2_at_least(max(num_groups, 1))
        fit = max(int(budget // per_group), 1)
        max_cap = max(1 << (fit.bit_length() - 1), 8)  # largest pow2 <= fit
        capacity = min(cap_full, max_cap)
        n_passes = (max(num_groups, 1) + capacity - 1) // capacity
        return capacity, n_passes

    def _cell_cols(self, m: _Match, specs, capacity: int) -> dict:
        """{column: cardinality bound} of the columns eligible for the
        int-dictionary cell lane (pixie_tpu/parallel/pipeline.py:4230-4267):
        INT64, read ONLY as the bare argument of cell-capable UDAs, in no
        predicate or key. The bound keeps capacity * C within the
        reference's segment budget, so both packages stage the same codes
        and take the same lane (the budget bounds the reference's one-hot
        einsum; here it bounds H1's histogram and H20/H21's cells)."""
        max_card = min(256, CELL_MAX_CELLS // max(capacity, 1))
        if max_card < 2:
            return {}
        blocked = set()
        for p in m.predicates:
            blocked |= referenced_columns(p)
        for g in m.agg_op.groups:
            blocked |= referenced_columns(m.col_exprs[g])
        consumers: dict[str, list] = {}
        for _out, arg_e, uda in specs:
            if not uda.reads_args:
                continue
            for col in referenced_columns(arg_e):
                consumers.setdefault(col, []).append((arg_e, uda))
        out = {}
        for col, cons in consumers.items():
            if col in blocked:
                continue
            try:
                if m.source_relation.col(col).data_type != DataType.INT64:
                    continue
            except KeyError:
                continue
            if all(isinstance(ae, ColumnRef) and u.cell_update is not None for ae, u in cons):
                out[col] = max_card
        return out

    # -- the mesh ----------------------------------------------------------------
    def _replicate(self, tensors: dict) -> list:
        """``tensors`` (on the root) on every shard's device: one dict a
        shard, one copy a distinct device (the reference replicates its aux
        values, LUTs and tables over the mesh)."""
        per_device = {self.device: tensors}
        for dev in self.mesh.distinct_devices():
            if dev not in per_device:
                per_device[dev] = {k: v.to(dev) for k, v in tensors.items()}
        return [per_device[dev] for dev in self.mesh.devices]

    def _flat_on_root(self, lane) -> torch.Tensor:
        """A staged lane as one flat [D * nblk * B] tensor on the root, the
        shards in device order (the reference's all_gather over the mesh):
        row order, since shard i holds the rows after shard i - 1's."""
        if isinstance(lane, torch.Tensor):
            return lane.reshape(-1)
        return torch.cat([merge.to_root(p.reshape(-1), self.device) for p in lane.parts])

    def merge_device_ms(self) -> float:
        """Milliseconds of K18 (the cross-shard merge) since the last call:
        on CUDA the root stream's time from the first copy's wait to the last
        merge, read from events once the query has fetched; on the CPU the
        host's time."""
        with self._cache_lock:
            marks, self._merge_marks = self._merge_marks, []
        total = 0.0
        for start, end in marks:
            total += start.elapsed_time(end) if isinstance(start, torch.cuda.Event) else end - start
        return total

    def _merge(self, specs, shard_states: list, shard_presence: list) -> tuple:
        """K18 (``merge.merge_states``) at the root, its span marked for
        ``merge_device_ms`` when there is more than one shard."""
        if len(shard_states) == 1:
            return list(shard_states[0]), shard_presence[0]
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        else:
            start = time.perf_counter() * 1e3
        with timed("merge"):
            out = merge.merge_states(specs, shard_states, shard_presence, self.device)
        if cuda:
            end.record(stream)
        else:
            end = time.perf_counter() * 1e3
        with self._cache_lock:
            self._merge_marks.append((start, end))
        return out

    def _hist_cols(self, specs, staged, capacity: int, cell_cols: dict) -> dict:
        """{column: C} of the cell lane's histograms: the cell columns the
        staging encoded, where capacity * C is within the budget."""
        cell = {arg_e.name for _, arg_e, uda in specs if _cell_served(arg_e, uda, cell_cols)}
        return {
            col: len(staged.int_dicts[col]) for col in cell
            if col in staged.int_dicts and capacity * len(staged.int_dicts[col]) <= CELL_MAX_CELLS
        }

    def _make_scan_bodies(self, specs, program, staged, key_plan, capacity, auxes: list,
                          cell_cols, pred_batch: Optional[batched.TermTable] = None):
        """(one ``_make_scan_body`` body a shard, hist_cols): shard s reads
        its own blocks with ``auxes[s]``, on its device."""
        bodies = []
        for s in range(staged.num_shards):
            dev = staged.shard_device(s)
            body, hist_cols = self._make_scan_body(
                specs, program, staged.shard(s), key_plan, capacity, auxes[s], cell_cols,
                pred_batch=None if pred_batch is None else pred_batch.to(dev),
            )
            bodies.append(body)
        if hist_cols:
            segment.lane_count("cell_lane")
        return bodies, hist_cols

    # -- the fold --------------------------------------------------------------
    def _make_scan_body(self, specs, program, staged, key_plan, capacity, aux, cell_cols,
                        pred_batch: Optional[batched.TermTable] = None):
        """The per-block fold: body(carry, block, gid_base) updates ``carry``
        (``_new_carry``). One H17 launch evaluates the block's mask (its
        predicates ANDed in), its gids (a dictionary key's codes, or the LUT
        key's per-code gids) and every UDA argument that is not a bare
        column (a string-hash argument gathered through its content-hash
        LUT); rows outside this pass's gid window are masked; then every UDA
        updates: the sum-family UDAs and the presence row in one fused
        segment sum (H1), the f64 rows of the moment UDAs (sum over
        FLOAT64, mean, variance, stddev) in one f64 segment sum (H2, each
        (column, op) once), their counts the presence row; the others
        through their own update.

        The cell lane (pixie_tpu/parallel/pipeline.py:5453-5510): a
        cell-capable UDA over a column staged as int-dictionary codes takes
        no rows. Each block adds its masked (group, code) counts, gids * C +
        code, into the pass's histogram (H1), and ``_finish_pass`` folds the
        histogram into the state once (``cell_update``: H20, H21); max and
        integer sums do not depend on order, so this gives the reference's
        per-block updates. Where capacity * C is over the budget (a cached
        staging under a larger capacity), the UDA takes the row path on
        LUT-gathered values; a cell column the staging did not encode (too
        many values) takes it on its raw values.

        With ``pred_batch`` (the predicate-batched fold, K16:
        pixie_tpu/parallel/pipeline.py:5539-5600) the body serves one slot
        per query: body(carries, block, gid_base) with one carry a slot.
        ``program`` is the predicate-erased program (its mask is the block's
        validity), gids and arguments are shared; H22 gives every row its
        slot bits from the block mask and the term table, ONE H23 launch
        adds the sum family of every slot (count and mean's count are the
        slot's presence, integer sums, f64 sums and mean's sums), and every
        other UDA and the cell lane's histogram update once per slot under
        that slot's mask, read from the bits. H23 reads every row as the fold
        staged it (a narrowed argument as a ``segment.Narrow``).

        ``staged`` is one shard (``StagedColumns.shard``) and ``aux`` on its
        device. Returns (body, hist_cols), hist_cols {column: C} of the
        histogram lanes."""
        host_gids = key_plan.host_gids is not None
        cell = {
            out: arg_e.name for out, arg_e, uda in specs if _cell_served(arg_e, uda, cell_cols)
        }
        hist_cols = self._hist_cols(specs, staged, capacity, cell_cols)

        def cell_values(col: str, blk: int, uda):
            """The row path's values of a cell column: LUT-gathered codes, or
            the column as staged (a narrowed one as a ``segment.Narrow`` to
            a UDA that takes it, else widened)."""
            if col in staged.int_dicts:
                codes = staged.blocks[col][0, blk].to(torch.int64)
                return aux[f"intdict:{col}"][codes]
            if uda.narrow_args and col in staged.narrow_offsets:
                return segment.Narrow(staged.blocks[col][0, blk], staged.narrow_offsets[col])
            return self._block_env(staged, blk, [col])[col]

        def prologue(blk: int, gid_base: int, keep=frozenset()) -> tuple:
            """(program results, the mask in this pass's gid window, gids
            relative to the window)."""
            vals = self._run_block(program, staged, blk, aux, keep)
            mask = vals["__mask__"]
            if host_gids:
                gids = staged.gids[0, blk].to(torch.int32)
            elif "__gids__" in vals:
                gids = vals["__gids__"]
            else:
                gids = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
            gids = gids - gid_base
            gid_ok = (gids >= 0) & (gids < capacity)
            return vals, mask & gid_ok, torch.clamp(gids, 0, capacity - 1)

        def update_states(carry: dict, vals, gids, mask, blk: int, done: dict) -> None:
            """The cell lane's histograms and every state not in ``done``
            ({out: its new state}) under ``mask``; ``vals`` the arguments
            (``arg:<out>``)."""
            for col, C in hist_cols.items():
                flat = gids * C + staged.blocks[col][0, blk].to(torch.int32)
                carry["hists"][col] += segment.seg_count(flat, capacity * C, mask)
            new_states = []
            for (out, arg_e, uda), st in zip(specs, carry["states"]):
                if out in done:
                    new_states.append(done[out])
                elif out in cell:
                    if cell[out] in hist_cols:
                        new_states.append(st)  # folded once, in _finish_pass
                    else:
                        new_states.append(
                            uda.update(st, gids, cell_values(cell[out], blk, uda), mask=mask)
                        )
                elif not uda.reads_args:
                    new_states.append(uda.update(st, gids, gids, mask=mask))
                else:
                    new_states.append(uda.update(st, gids, vals[f"arg:{out}"], mask=mask))
            carry["states"] = new_states

        staged_args = self._staged_args(specs, program, staged, cell)
        keep = frozenset(staged_args.values())

        def staged_prologue(blk: int, gid_base: int) -> tuple:
            """``prologue`` with the staged arguments as ``segment.Narrow``."""
            vals, mask, gids = prologue(blk, gid_base, keep)
            for out, col in staged_args.items():
                vals[f"arg:{out}"] = segment.Narrow(vals[f"arg:{out}"], staged.narrow_offsets[col])
            return vals, mask, gids

        def body(carry: dict, blk: int, gid_base: int) -> None:
            vals, mask, gids = staged_prologue(blk, gid_base)
            rows, frows = [], []
            fused: dict[str, tuple[int, int]] = {}
            moment: dict[str, list] = {}  # out: [(is an f64 row, its index)]
            fkeys: dict[tuple, int] = {}
            for out, arg_e, uda in specs:
                if out in cell or (uda.fused_rows is None and uda.moment_rows is None):
                    continue
                col = vals[f"arg:{out}"] if uda.reads_args else None
                if uda.fused_rows is not None:
                    r = uda.fused_rows(col, mask)
                    fused[out] = (len(rows), len(rows) + len(r))
                    rows.extend(r)
                    continue
                where = []
                for r in uda.moment_rows(col, mask):
                    if isinstance(r, segment.F64Row):
                        # stddev and variance of one column share its rows
                        i = fkeys.setdefault(r.key(), len(frows))
                        if i == len(frows):
                            frows.append(r)
                        where.append((True, i))
                    else:
                        where.append((False, len(rows)))
                        rows.append(r)
                moment[out] = where
            totals = segment.fused_segment_sums(rows, gids, capacity, mask)
            ftotals = segment.f64_segment_sums(frows, gids, capacity, mask) if frows else None
            presence = totals[-1]
            carry["presence"] = carry["presence"] + presence
            done = {}
            for (out, _, uda), st in zip(specs, carry["states"]):
                if out in fused:
                    done[out] = uda.fused_apply(st, totals[fused[out][0] : fused[out][1]])
                elif out in moment:
                    t = [ftotals[i] if f else totals[i] for f, i in moment[out]]
                    done[out] = uda.moment_apply(st, t, presence)
            update_states(carry, vals, gids, mask, blk, done)

        if pred_batch is None:
            return body, hist_cols

        lanes = {out: _sum_lane(uda) for out, _, uda in specs if out not in cell}
        lanes = {out: lane for out, lane in lanes.items() if lane is not None}
        per_slot = bool(hist_cols) or len(lanes) < len(specs)

        def batched_body(carries: list, blk: int, gid_base: int) -> None:
            vals, base, gids = staged_prologue(blk, gid_base)
            cols, offsets = batched.term_columns(staged, pred_batch, blk)
            bits = batched.slot_masks(cols, offsets, base, pred_batch)
            irows, frows, where = [], [], {}
            for out, lane in lanes.items():  # every row as staged (H23 reads it so)
                if lane == "sum_i":
                    where[out] = len(irows)
                    irows.append(vals[f"arg:{out}"])
                elif lane in ("sum_f", "mean"):
                    where[out] = len(frows)
                    frows.append(vals[f"arg:{out}"])
            ti, tf = batched.batched_segment_sums(irows, frows, gids, bits, len(carries), capacity)
            R = len(irows)
            for s, carry in enumerate(carries):
                presence = ti[s, R]
                carry["presence"] = carry["presence"] + presence
                done = {}
                for (out, _, _), st in zip(specs, carry["states"]):
                    lane = lanes.get(out)
                    if lane == "count":
                        done[out] = st + presence
                    elif lane == "sum_i":
                        done[out] = st + ti[s, where[out]]
                    elif lane == "sum_f":
                        done[out] = st + tf[s, where[out]]
                    elif lane == "mean":
                        done[out] = {"sum": st["sum"] + tf[s, where[out]],
                                     "count": st["count"] + presence}
                if per_slot:
                    update_states(carry, vals, gids, batched.slot_mask(bits, s), blk, done)
                else:
                    carry["states"] = [done[out] for out, _, _ in specs]

        return batched_body, hist_cols

    @staticmethod
    def _staged_args(specs, program, staged, cell: dict) -> dict:
        """{out: column} of the arguments the fold hands over as staged
        (``segment.Narrow``) instead of widened: a bare narrowed column
        whose every reader takes one (``uda.narrow_args``) and which no
        other passthrough of the program hands on."""
        readers: dict[str, list] = {}
        for out, arg_e, uda in specs:
            if out not in cell and uda.reads_args and isinstance(arg_e, ColumnRef):
                readers.setdefault(arg_e.name, []).append((out, uda))
        sources: dict[str, set] = {}
        for name, (src, dt) in program.passthrough.items():
            if isinstance(src, str):
                sources.setdefault(src, set()).add(name if dt is None else None)
        out = {}
        for col, users in readers.items():
            if col not in staged.narrow_offsets or not all(u.narrow_args for _, u in users):
                continue
            if sources.get(col, set()) == {f"arg:{o}" for o, _ in users}:
                out.update((o, col) for o, _ in users)
        return out

    @staticmethod
    def _new_carry(specs, capacity: int, hist_cols: dict, device) -> dict:
        """One shard's fold state for a pass, on its device: the UDA states,
        the presence counter and the cell lane's (group, code) histograms."""
        return {
            "states": [uda.init(capacity, device) for _, _, uda in specs],
            "presence": torch.zeros(capacity, dtype=torch.int64, device=device),
            "hists": {
                col: torch.zeros(capacity * C, dtype=torch.int64, device=device)
                for col, C in hist_cols.items()
            },
        }

    def _new_carries(self, specs, capacity: int, hist_cols: dict, staged) -> list:
        return [
            self._new_carry(specs, capacity, hist_cols, staged.shard_device(s))
            for s in range(staged.num_shards)
        ]

    @staticmethod
    def _shard_states(specs, carry: dict, capacity: int, aux: dict, hist_cols: dict,
                      cell_cols: dict) -> list:
        """One shard's states at the end of a pass: each cell-lane UDA takes
        its histogram (H20, H21)."""
        states = list(carry["states"])
        for i, (out, arg_e, uda) in enumerate(specs):
            if _cell_served(arg_e, uda, cell_cols) and arg_e.name in hist_cols:
                col = arg_e.name
                hist = carry["hists"][col].reshape(capacity, hist_cols[col])
                states[i] = uda.cell_update(states[i], hist, aux[f"intdict:{col}"])
        return states

    def _finish_pass(self, specs, carries: list, capacity: int, auxes: list, hist_cols: dict,
                     cell_cols: dict, force_state: bool = False) -> list:
        """The pass's outputs on the root: every shard's states, merged over
        the shards (K18), then finalized (or, with ``force_state``, packed
        as raw states)."""
        shard_states = [
            self._shard_states(specs, c, capacity, a, hist_cols, cell_cols)
            for c, a in zip(carries, auxes)
        ]
        states, presence = self._merge(specs, shard_states, [c["presence"] for c in carries])
        return self._finalize_pack(specs, states, presence, force_state)

    def _finalize_pack(self, specs, states, presence, force_state: bool = False) -> list:
        """Finalize on the device where the UDA allows it (device_finalize,
        else finalize): one output tensor per spec; a UDA whose finalize
        makes host values (``_state_mode``) packs its state's leaves instead
        (``_state_keys`` order), which ride the pass's one device -> host
        copy; then presence. ``force_state`` (a PARTIAL fold: raw states
        cross the bridge, pixie_tpu/parallel/pipeline.py:4698) packs every
        UDA's state leaves."""
        outs = []
        for (_, _, uda), st in zip(specs, states):
            if force_state or _state_mode(uda):
                keys = _state_keys(uda)
                outs.extend([st[key] for key in keys] if keys is not None else [st])
            elif uda.device_finalize is not None:
                outs.append(uda.device_finalize(st))
            else:
                outs.append(uda.finalize(st))
        return outs + [presence]

    @staticmethod
    def _outputs(per_pass: list) -> tuple:
        """(outputs, presence) of the passes' outputs, each leaf's passes
        concatenated (a PARTIAL fold's state leaves on the device)."""
        leaves = [
            parts[0] if len(parts) == 1
            else torch.cat(parts) if isinstance(parts[0], torch.Tensor)
            else np.concatenate(parts, axis=0)
            for parts in zip(*per_pass)
        ]
        return leaves[:-1], leaves[-1]

    def _run_program(self, specs, program, key_plan, staged, aux, cell_cols,
                     force_state: bool = False):
        """Fold every block, pass by pass: every shard folds its own blocks
        into its own carry (block by block across the shards, so every
        device has work queued), then the carries merge at the root; returns
        (([per-spec output], presence) as numpy, capacity)."""
        capacity, n_passes = self._pass_plan(specs, key_plan.num_groups)
        auxes = self._replicate(aux)
        bodies, hist_cols = self._make_scan_bodies(
            specs, program, staged, key_plan, capacity, auxes, cell_cols
        )

        def one_pass(p: int) -> list:
            carries = self._new_carries(specs, capacity, hist_cols, staged)
            for blk in range(staged.num_blocks):
                for body, carry in zip(bodies, carries):
                    body(carry, blk, p * capacity)
            # ONE blocking device -> host copy per pass.
            return _fetch_slots([self._finish_pass(
                specs, carries, capacity, auxes, hist_cols, cell_cols, force_state
            )], force_state)[0]

        per_pass = [
            self._mesh_dispatch(lambda: one_pass(p), what="warm_fold") for p in range(n_passes)
        ]
        return self._outputs(per_pass), capacity

    # -- shared scans (K16 and the coordinator) --------------------------------
    def _shared_scan_run(
        self, m, specs, evaluator, table, key_plan, roots, program, aux, host_aux,
        staged_key, staged, cell_cols,
    ):
        """The warm fold through the shared-scan coordinator (flag
        ``shared_scans``; pixie_tpu/parallel/pipeline.py:6489): concurrent
        queries whose keys match share ONE dispatch, and each finalizes its
        own outputs. Returns what ``_run_program`` returns.

        The EXACT key is everything the outputs depend on: the staged
        entry's identity (its cache key and ``id``), the H17 program with
        its predicates (``_program_sig``: the query's output names left
        out), the UDA lanes, the key mode, capacity and passes
        (``_fold_lanes``), the agg stage, and a digest of the aux values
        (string-constant codes, function tables, content-hash LUTs, the key
        LUT) with each int-dictionary column's value LUT. Output names and
        finalize modes are not in it: queries that differ only there share.

        When the predicates normalize to data terms
        (``normalize_predicates``) the query also offers a BATCH key: the
        same, but with the predicate-erased program (``preds=[]``) and only
        the aux that no predicate owns. Queries matching on it fold as the
        slots of one ``_run_program_batched`` dispatch. A query with more
        terms or term columns than one term table holds (H22's limits)
        offers none."""
        capacity, n_passes = self._pass_plan(specs, key_plan.num_groups)
        lanes = self._fold_lanes(specs, key_plan, capacity, n_passes, cell_cols)
        stage = m.agg_op.stage.value
        intdicts = [np.asarray(staged.int_dicts[c]) for c in sorted(staged.int_dicts)]
        key = (
            staged_key, id(staged), _program_sig(program, specs), lanes, stage,
            aux_digest(list(host_aux.values()) + intdicts),
        )

        force_state = m.agg_op.stage == AggStage.PARTIAL

        def compute():
            return self._run_program(specs, program, key_plan, staged, aux, cell_cols,
                                     force_state)

        batch_key = terms = compute_batch = None
        if flags.shared_scan_predicate_batching:
            terms = normalize_predicates(m.predicates, evaluator, staged, host_aux)
            if terms is not None and not batched.fits([terms]):
                terms = None
        if terms is not None:
            # The predicates' constants and tables ride the term table as
            # data: they leave the erased program and the batch key (but for
            # a table the erased program reads too).
            erased = evaluator.compile_program(
                roots, _register_dtypes(m.source_relation), aux, mask=("__valid__", [])
            )
            owned = set()
            for p in m.predicates:
                for e in walk(p):
                    owned |= {f"const:{id(e)}", f"lut:{id(e)}"}
            owned -= set(erased.luts)
            shared = [v for k, v in host_aux.items() if k not in owned]
            batch_key = (
                staged_key, id(staged), _program_sig(erased, specs), lanes, stage,
                aux_digest(shared + intdicts),
            )

            def compute_batch(slot_terms):
                return self._run_program_batched(
                    specs, erased, key_plan, staged, aux, cell_cols, slot_terms, force_state
                )

        return self._shared_scans.run(
            key, compute, batch_key=batch_key, terms=terms, compute_batch=compute_batch
        )

    @staticmethod
    def _fold_lanes(specs, key_plan, capacity: int, n_passes: int, cell_cols: dict) -> tuple:
        """The fold's UDA lanes (name, argument types, argument), key mode,
        group count, capacity, passes and cell columns: with the staged
        entry and the program, what the outputs depend on."""
        if key_plan.host_gids is not None:
            key_mode = "host"
        elif isinstance(key_plan.device_expr, tuple):
            key_mode = f"lut:{key_plan.device_expr[1]}"
        else:
            key_mode = repr(key_plan.device_expr)
        return (
            tuple(
                (uda.name, tuple(t.name for t in uda.arg_types),
                 repr(arg_e) if uda.reads_args else None)
                for _, arg_e, uda in specs
            ),
            key_mode, key_plan.num_groups, capacity, n_passes, tuple(sorted(cell_cols.items())),
        )

    def _run_program_batched(self, specs, program, key_plan, staged, aux, cell_cols, slot_terms,
                             force_state: bool = False):
        """ONE scan of the staged blocks for ``len(slot_terms)`` queries (K16,
        pixie_tpu/parallel/pipeline.py:6883): each slot's outputs are what
        ``_run_program`` gives for that query alone. ``program`` is the
        predicate-erased program; each slot's predicates are its normalized
        terms, laid out in one term table (``batched.build_term_table``: B,
        T and L padded to powers of two) that goes to the device once. Every
        block runs the batched body (``_make_scan_body``: one H17, one H22
        and one H23 launch, then the other UDAs once a slot); each pass ends
        with every slot's ``_finish_pass`` and ONE device -> host copy for
        all slots. Slots beyond one table's limits (``batched.split_batch``)
        take further scans."""
        capacity, n_passes = self._pass_plan(specs, key_plan.num_groups)
        dtypes = {c: _block_dtype(shard_of(b, 0)) for c, b in staged.blocks.items()}
        auxes = self._replicate(aux)
        results: list = [None] * len(slot_terms)
        for run in batched.split_batch(slot_terms):
            table = batched.build_term_table([slot_terms[s] for s in run], dtypes)
            bodies, hist_cols = self._make_scan_bodies(
                specs, program, staged, key_plan, capacity, auxes, cell_cols, pred_batch=table,
            )
            per_slot: list = [[] for _ in run]

            def one_pass(p: int, run=run, bodies=bodies, hist_cols=hist_cols) -> tuple:
                # carries[shard][slot]
                carries = [
                    [self._new_carry(specs, capacity, hist_cols, staged.shard_device(sh))
                     for _ in run]
                    for sh in range(staged.num_shards)
                ]
                for blk in range(staged.num_blocks):
                    for body, shard_carries in zip(bodies, carries):
                        body(shard_carries, blk, p * capacity)
                outs = [
                    self._finish_pass(
                        specs, [c[i] for c in carries], capacity, auxes, hist_cols, cell_cols,
                        force_state,
                    )
                    for i in range(len(run))
                ]
                return _fetch_slots(outs, force_state)  # ONE copy per pass

            for p in range(n_passes):
                host = self._mesh_dispatch(lambda: one_pass(p), what="batched_fold")
                for i in range(len(run)):
                    per_slot[i].append(host[i])
            for i, s in enumerate(run):
                results[s] = (self._outputs(per_slot[i]), capacity)
        return results

    def _stream_execute(
        self, specs, program, key_plan, aux, cols: dict, n: int, f32_cols: set,
        cell_cols: dict, capacity: int, ring=None, base_row: int = 0,
        ckpt_ident: Optional[str] = None, force_state: bool = False,
    ):
        """The streamed cold path (pixie_tpu/parallel/pipeline.py:5939-6459,
        for one pass): (outputs, the staging for the warm cache). A
        background thread packs window k+1 into a pinned buffer while window
        k copies on a side stream of every device, decodes and folds on the
        compute streams (``WindowStager``); at most two windows' folds are in
        flight (:6243-6251). Every window is [D, nblk, b], shard s's part on
        its device; each shard folds its part of every window into its own
        carry, and the carries merge once, after the last window
        (``_build_fold``/``_build_merge``, :5805-5938). Every window lands in
        its slice of one preallocated staging, which is the warm-cache
        entry. With the table's resident ``ring`` (``base_row`` its first
        row id; its windows sharded over the same devices) the stream runs
        at the ring's window size, and a window the ring holds packs only
        its gids and converts its columns on the device, shard by shard,
        instead of copying them (:5990-6005, :6186-6197, :6310-6320).

        Each window's fold and the final merge are mesh dispatches
        (``_mesh_dispatch``, :6219-6225, :6391-6397). On an executor whose
        full geometry has more than one axis, with ``mesh_fold_checkpoint``,
        every window's carries are checkpointed to the host after its fold
        under ``ckpt_ident`` (the fold's identity, free of geometry) and
        the window size, and a fold that finds a checkpoint of its identity
        (an earlier attempt on a failed rung) adopts it on this rung's
        devices and folds only the later windows; the earlier windows still
        land in the staging (:6040-6061, :6255-6292). The reference catches
        any other error here and restages in one piece (:5946-5969); the
        port raises. Left out, as later queue items: the background AOT
        compiles (:6097-6133, :6430-6455; nothing is compiled here) and the
        cost model (:6232-6239, :6345-6356)."""
        import concurrent.futures

        gids = key_plan.host_gids
        window_rows = ring.window_rows if ring is not None else flags.streaming_window_rows
        plan = plan_stream(
            cols, n, window_rows, block_rows=self.block_rows,
            f32_cols=f32_cols, cell_cols=cell_cols, num_groups=max(key_plan.num_groups, 1),
            has_gids=gids is not None, gids=gids, d=self.mesh.size,
        )
        hits = self._resident_hits(ring, plan, base_row, sorted(cols))
        stager = WindowStager(plan, self.mesh.devices)
        staged = stager.staged
        aux = self._with_intdicts(aux, staged)
        auxes = self._replicate(aux)
        bodies, hist_cols = self._make_scan_bodies(
            specs, program, staged, key_plan, capacity, auxes, cell_cols
        )
        carries = self._new_carries(specs, capacity, hist_cols, staged)
        # Every rung keeps the device count, so the window geometry and the
        # carries' shapes are the same on every rung.
        ckpt_key = None
        start_w = 0
        if ckpt_ident is not None and self._checkpoints_apply():
            ckpt_key = f"{ckpt_ident}|win:{plan.window_rows}"
            resumed, start_w = self._load_fold_checkpoint(ckpt_key, carries, self.mesh.devices)
            if start_w:
                carries = resumed
                _MESH_RESUMES.inc()
                with self._geom_lock:
                    self._geom_events["resumes"] += 1

        def fold_window(w: int) -> None:
            for blk in range(w * plan.nblk, (w + 1) * plan.nblk):
                for body, carry in zip(bodies, carries):
                    body(carry, blk, 0)

        inflight: collections.deque = collections.deque()
        t_wall = time.perf_counter()
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="stream-pack"
        )
        # The pack thread runs under the query's trace context and
        # attribution, as the reference's does (:6292-6297).
        pack = trace.attributed(stager.pack, phase="pack")
        try:
            fut = pool.submit(pack, cols, gids, 0, 0 in hits)
            for w in range(plan.n_windows):
                with timed("stage_stream_pack_wait"):
                    win = fut.result()
                if w + 1 < plan.n_windows:
                    fut = pool.submit(pack, cols, gids, w + 1, (w + 1) in hits)
                with timed("stage_stream_put"):
                    if w in hits:
                        self._convert_resident_window(plan, hits[w], staged, w)
                    stager.put(win)
                profile_add("stage_bytes", plan.window_block_nbytes() + staged_gid_nbytes(win.gids))
                profile_add("wire_bytes", win.wire_nbytes)
                if w < start_w:
                    continue  # in the adopted carries: staged, never refolded
                with timed("stage_stream_dispatch"):
                    self._mesh_dispatch(lambda: fold_window(w), what="stream_fold")
                if stager.cuda:
                    done = []
                    for stream in stager.compute.values():
                        event = torch.cuda.Event()
                        event.record(stream)
                        done.append(event)
                    inflight.append(done)
                    if len(inflight) > 2:
                        with timed("stage_stream_compute_wait"):
                            for event in inflight.popleft():
                                event.synchronize()
                if ckpt_key is not None:
                    with timed("stage_stream_ckpt"):
                        self._checkpoint_carries(ckpt_key, w + 1, carries)
            with timed("stage_stream_drain"):
                outputs = self._mesh_dispatch(
                    lambda: self._outputs(_fetch_slots([self._finish_pass(
                        specs, carries, capacity, auxes, hist_cols, cell_cols, force_state
                    )], force_state)),
                    what="stream_merge",
                )
        finally:
            pool.shutdown(wait=True)
            profile_add("stage_overlap", time.perf_counter() - t_wall)
            profile_add("stream_windows", plan.n_windows)
        if ckpt_key is not None:
            # The fold's answer is out: its checkpoint must not outlive it.
            with self._geom_lock:
                self._fold_ckpt.pop(ckpt_key, None)
            if start_w:
                self.last_resume_stats = {
                    "resumed_from_window": int(start_w),
                    "refolded_windows": int(plan.n_windows - start_w),
                    "total_windows": int(plan.n_windows),
                }
        return outputs, staged

    def _partial_state_batch(self, m, specs, key_plan, outputs, table) -> StateBatch:
        """The PARTIAL stage's StateBatch for the MERGE consumer
        (pixie_tpu/parallel/pipeline.py:7297-7338): the observed groups'
        key columns and raw states, in gid order (a dictionary-keyed plan's
        unobserved slots left out; group-by-none its one group). The state
        leaves stay on the device; a code-valued state (any(STRING)) carries
        a snapshot of its column's dictionary, through which the merge
        translates its codes."""
        values, presence = outputs
        leaves = iter(values)
        n = max(key_plan.num_groups, 1) if m.agg_op.groups else 1
        keep = presence[:n] > 0 if m.agg_op.groups else np.ones(1, dtype=bool)
        idx = np.nonzero(keep)[0]
        key_columns = [
            col.take(idx) if isinstance(col, DictColumn) else np.asarray(col)[idx]
            for col in key_plan.key_columns
        ]
        sel = {}

        def kept(leaf: torch.Tensor) -> torch.Tensor:
            ix = sel.get(leaf.device)
            if ix is None:
                ix = sel[leaf.device] = torch.from_numpy(idx).to(leaf.device)
            return leaf[:n].index_select(0, ix)

        states, arg_dicts = {}, {}
        for out_name, arg_e, uda in specs:
            keys = _state_keys(uda)
            if keys is None:
                states[out_name] = kept(next(leaves))
            else:
                states[out_name] = {key: kept(next(leaves)) for key in keys}
            if uda.string_state and isinstance(arg_e, ColumnRef):
                d = table.dictionaries.get(arg_e.name)
                if d is not None:
                    arg_dicts[out_name] = StringDictionary(list(d.values()))
        return StateBatch(
            key_columns=key_columns,
            states=states,
            num_groups=len(idx),
            group_names=m.agg_op.groups,
            eow=True,
            eos=True,
            arg_dicts=arg_dicts,
        )

    def _finalize(
        self, m, specs, key_plan, outputs, registry, table, host_any=None,
        group_range: Optional[tuple] = None, eos: bool = True,
    ) -> RowBatch:
        """Emit only the observed groups (presence > 0), in gid order — the
        dictionary-code order — as the reference's _finalize does. ``outputs``
        hold the device specs' values (those not in ``host_any``); host any()
        representatives and code-valued states decode through the table's
        dictionary (pixie_tpu/parallel/pipeline.py:7397-7438). A windowed
        fold finalizes window by window: ``group_range`` (offset, count) is
        one window's slice of the (window, group) slots, its batch ``eow``
        and ``eos`` on the last window only (:7340-7370); group-by-none
        emits one row a window, an empty window's too."""
        host_any = host_any or {}
        values, presence = outputs
        if group_range is not None:
            off, cnt = group_range
            values = [v[off : off + cnt] for v in values]
            presence = presence[off : off + cnt]
            n = cnt if m.agg_op.groups else 1
        else:
            n = max(key_plan.num_groups, 1) if m.agg_op.groups else 1
        device_vals = iter(values)
        rel = m.agg_op.output_relation([_pre_agg_relation(m, registry)], registry)
        if m.agg_op.groups:
            keep = presence[:n] > 0
        else:
            keep = np.ones(1, dtype=bool)  # group-by-none keeps its one row
        idx = np.nonzero(keep)[0]
        out_cols: list = [
            col.take(idx) if isinstance(col, DictColumn) else np.asarray(col)[idx]
            for col in key_plan.key_columns
        ]
        for out_name, arg_e, uda in specs:
            schema = rel.col(out_name)
            if out_name in host_any:
                out = np.asarray(host_any[out_name])[:n][keep]
            elif _state_mode(uda):
                # The reference's "state" mode (pipeline.py:7416-7418):
                # finalize on the fetched state, sliced to the groups kept.
                keys = _state_keys(uda)
                if keys is None:
                    out = uda.finalize(next(device_vals)[:n][keep])
                else:
                    out = uda.finalize({key: next(device_vals)[:n][keep] for key in keys})
            else:
                arr = next(device_vals)[:n][keep]
                out = (
                    uda.format_output(arr)
                    if uda.device_finalize is not None and uda.format_output is not None
                    else arr
                )
            if schema.data_type != DataType.STRING:
                out_cols.append(np.asarray(out, dtype=host_dtype(schema.data_type)))
                continue
            if uda.string_state:
                # Code-valued state (any(STRING)): decode through the table
                # dictionary of its bare source column.
                vals = table.dictionaries[arg_e.name].decode(np.asarray(out).astype(np.int32))
            else:
                vals = np.asarray(out, dtype=object)
            d = StringDictionary()
            out_cols.append(DictColumn(d.encode(np.asarray(vals, dtype=object)), d))
        return RowBatch(rel, out_cols, eow=True, eos=eos)


def _first_rows(codes: torch.Tensor, num_codes: int) -> torch.Tensor:
    """int64 [num_codes + 1]: the first row of each code of ``codes`` (the
    last entry: of the null code -1), int64 max for a code that does not
    occur: the segment min of the row index, H11 on the card."""
    n = codes.shape[0]
    ids = torch.remainder(codes.to(torch.int64), num_codes + 1)
    return segment.seg_min(torch.arange(n, device=codes.device), ids, num_codes + 1)


def _reencode_outer_nulls(codes: np.ndarray, d: StringDictionary, first: np.ndarray):
    """(dictionary, codes) of an outer join's STRING column whose null rows
    (code -1) read "", the host node's type default: what the reference
    gets by decoding every row and re-encoding the strings into a fresh
    dictionary (pixie_tpu/parallel/pipeline.py:3404-3416, RowBatch.from_pydict),
    computed from the codes and each code's first row (``_first_rows``)
    without per-row string work. The numbering matters downstream (a host
    AggNode emits a batch's groups in code order). StringDictionary.encode
    numbers new values by first occurrence on its native path, which it
    takes from 1024 rows up, and in sorted order below: the distinct values
    in first-occurrence order, padded to 1024 entries where the column has
    that many, take the same path and get the same numbering."""
    values = d.values()
    n = len(codes)
    seen = np.flatnonzero(first < n)
    seen = seen[np.argsort(first[seen], kind="stable")]
    proxy = np.asarray(values + [""], dtype=object)[seen]
    if n >= 1024 and len(proxy) < 1024:
        proxy = np.concatenate([proxy, np.repeat(proxy[:1], 1024 - len(proxy))])
    out = StringDictionary()
    lut = np.zeros(len(values) + 1, dtype=np.int32)
    lut[seen] = out.encode(proxy)[: len(seen)]
    return out, lut[codes]  # code -1 reads lut[-1], the null's entry


def _pre_agg_relation(m: _Match, registry):
    return MapOp(
        tuple((name, e) for name, e in m.col_exprs.items())
    ).output_relation([m.source_relation], registry)
