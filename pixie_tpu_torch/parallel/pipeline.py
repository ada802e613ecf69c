"""The device fold: source -> map/filter -> aggregate on one CUDA device.

Counterpart of pixie_tpu/parallel/pipeline.py's MeshExecutor for the simple
aggregation core. Fragments of the shape

    MemorySource -> (Map | Filter)* -> Agg(FULL, not windowed)

run here. A group key that is one dictionary-coded string column is its
codes, evaluated per block on the device; any other key (several columns,
ints, computed values) is densified on the host by a chunked GroupEncoder
pass over the table (cached per table version) and its gids stage as one
more per-block lane. The needed columns are staged once
(parallel/staging.py, cached per table version), then every block is folded
into the UDA states by ``_make_scan_body`` — predicates as elementwise torch
ops, the sum-family UDAs and the presence counter through ONE fused segment
sum (kernel H1), every other UDA through its own update (H2, H3, the sketch
kernels H5-H8) — and the states are finalized on the device (H4, H9, H10)
and fetched with one device -> host copy per pass. On one device the
reference's cross-device merge (``_merge_states``) is the identity, so the
port has none yet.

A fragment outside that shape — windowed or PARTIAL aggregation, string-hash
UDA args — returns None and reaches the host exec graph, which raises
NotImplementedError for the aggregation: the port has no host AggNode and no
fallback. Errors raise; nothing is caught and sent elsewhere.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from pixie_tpu_torch.compiler.analyzer import substitute
from pixie_tpu_torch.device import resolve_device
from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
from pixie_tpu_torch.exec.group_encoder import GroupEncoder
from pixie_tpu_torch.ops import segment
from pixie_tpu_torch.parallel.staging import (
    StagedColumns,
    _pow2_at_least,
    read_columns,
    stage_columns,
    timed,
)
from pixie_tpu_torch.plan.expressions import (
    ColumnRef,
    expr_data_type,
    referenced_columns,
)
from pixie_tpu_torch.plan.operators import (
    AggOp,
    AggStage,
    FilterOp,
    MapOp,
    MemorySourceOp,
)
from pixie_tpu_torch.plan.plan import PlanFragment
from pixie_tpu_torch.table.column import DictColumn, StringDictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.types.dtypes import host_dtype
from pixie_tpu_torch.utils import flags


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
class _KeyPlan:
    """How gids materialize: ``device_expr`` evaluated per block on the
    device, or ``host_gids`` densified on the host (neither: one group)."""

    device_expr: Optional[Any] = None
    host_gids: Optional[np.ndarray] = None
    num_groups: int = 0
    key_columns: list = dataclasses.field(default_factory=list)


_NP_DTYPES = {
    torch.bool: np.bool_,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


def _fetch(tensors: list) -> list:
    """Bring device tensors to the host with ONE device -> host copy: each
    is viewed as bytes, the bytes are concatenated, copied, and split."""
    parts = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for t, p in zip(tensors, parts):
        n = p.numel()
        out.append(host[off : off + n].view(_NP_DTYPES[t.dtype]).reshape(tuple(t.shape)))
        off += n
    return out


def _state_bytes(state) -> int:
    leaves = state.values() if isinstance(state, dict) else [state]
    return sum(t.numel() * t.element_size() for t in leaves)


class DeviceExecutor:
    """Runs matching fragments on one device: ``device=None`` is the CUDA
    card (raising when there is none), ``device="cpu"`` runs the plain
    PyTorch versions of the kernels."""

    def __init__(self, device=None, block_rows: Optional[int] = None):
        self.device = resolve_device(device)
        self.block_rows = (
            block_rows if block_rows is not None else flags.device_block_rows
        )
        # Staged columns per (table version, columns, key plan, ...), LRU:
        # a table version is staged once and every matching query reuses it.
        self._staged_cache: "collections.OrderedDict[tuple, StagedColumns]" = (
            collections.OrderedDict()
        )
        self._staged_cache_cap = flags.staged_cache_cap
        # Host-densified key plans per (table version, key exprs, window), LRU.
        self._keyplan_cache: "collections.OrderedDict[tuple, _KeyPlan]" = (
            collections.OrderedDict()
        )
        self._keyplan_cache_cap = flags.keyplan_cache_cap
        self.last_fold_ms: Optional[float] = None

    # -- public -------------------------------------------------------------
    def try_execute_fragment(
        self, fragment: PlanFragment, table_store, registry, func_ctx=None
    ) -> Optional[tuple[int, RowBatch]]:
        """(agg node id, finalized agg RowBatch) when the fragment has the
        device shape, else None (the host graph then runs the fragment)."""
        t0 = time.perf_counter()
        table_rel = lambda op: table_store.get_relation(op.table_name)
        relations = fragment.resolve_relations(registry, table_rel)
        m = match_fragment(fragment, relations)
        if m is None or m.agg_op.stage != AggStage.FULL or m.agg_op.windowed:
            return None
        table = table_store.get_table(m.source_op.table_name)
        if table is None:
            return None
        specs = self._agg_specs(m, registry)
        if specs is None:
            return None
        evaluator = self._make_evaluator(m, specs, registry, func_ctx)
        if evaluator is None:
            return None
        # UDAs that never read their column (count) stage nothing for it.
        base_cols = set()
        for e in m.predicates:
            base_cols |= referenced_columns(e)
        for _, e, uda in specs:
            if uda.reads_args:
                base_cols |= referenced_columns(e)
        key_plan = self._plan_keys(m, table, registry, func_ctx, base_cols)
        if key_plan is None:
            return None
        f32_cols = self._sketch_f32_cols(m, specs)
        key_sig = repr([m.col_exprs[g] for g in m.agg_op.groups]) + ":dev"
        # Version = (min_row_id, end_row_id): writes bump end_row_id and
        # ring-buffer expiry bumps min_row_id, so either invalidates.
        version = (table.min_row_id(), table.end_row_id())
        cache_key = (
            m.source_op.table_name,
            version,
            tuple(sorted(base_cols)),
            m.source_op.start_time,
            m.source_op.stop_time,
            self.block_rows,
            key_sig,
            key_plan.num_groups,
            tuple(sorted(f32_cols)),
        )
        staged = self._staged_lookup(cache_key)
        if staged is None:
            with timed("read_columns"):
                cols, n = read_columns(
                    table,
                    sorted(base_cols),
                    m.source_op.start_time,
                    m.source_op.stop_time,
                )
            with timed("stage"):
                staged = stage_columns(
                    cols, n, self.device, block_rows=self.block_rows,
                    f32_cols=f32_cols, gids=key_plan.host_gids,
                    num_groups=key_plan.num_groups,
                )
            self._staged_insert(cache_key, staged)
        aux = self._build_aux(evaluator, table)
        with timed("fold"):
            outputs, capacity = self._run_program(
                specs, evaluator, key_plan, staged, aux
            )
        batch = self._finalize(m, specs, key_plan, outputs, registry)
        self.last_fold_ms = (time.perf_counter() - t0) * 1e3
        return m.agg_nid, batch

    def clear_caches(self) -> None:
        """Drop the staged columns and key plans: the next query of every
        table is cold."""
        self._staged_cache.clear()
        self._keyplan_cache.clear()

    # -- staged-column cache -------------------------------------------------
    def _staged_lookup(self, cache_key) -> Optional[StagedColumns]:
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
                    break
        if staged is not None:
            self._staged_cache.move_to_end(cache_key)
        return staged

    def _staged_insert(self, cache_key, staged) -> None:
        # Entries of older versions of the same table can never hit again.
        table_name, version = cache_key[:2]
        for k in [
            k for k in self._staged_cache if k[0] == table_name and k[1] != version
        ]:
            del self._staged_cache[k]
        self._staged_cache[cache_key] = staged
        while len(self._staged_cache) > max(self._staged_cache_cap, 1):
            self._staged_cache.popitem(last=False)

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
            if len(arg_exprs) != 1 or types[0] == DataType.STRING:
                return None  # multi-arg and string-arg UDAs: not in the slice
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
            return ExpressionEvaluator(named, m.source_relation, registry, func_ctx)
        except ValueError:
            return None

    def _plan_keys(self, m: _Match, table, registry, func_ctx, base_cols: set):
        """No key: one group. One bare string column with a dictionary: its
        codes are the gids, evaluated on the device. Any other key: densified
        on the host (``_host_key_plan``)."""
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
        return self._host_key_plan(m, table, registry, func_ctx)

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
            [(g, m.col_exprs[g]) for g in groups], sub_rel, registry, func_ctx
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
        for k in [
            k for k in self._keyplan_cache
            if k[0] == m.source_op.table_name and k[1] != kp_key[1]
        ]:
            del self._keyplan_cache[k]
        self._keyplan_cache[kp_key] = kp
        while len(self._keyplan_cache) > max(self._keyplan_cache_cap, 1):
            self._keyplan_cache.popitem(last=False)
        return kp

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

    def _build_aux(self, evaluator, table) -> dict:
        """String-constant codes and dict-func LUTs of the predicates and
        args, as tensors on the device."""
        aux: dict[str, np.ndarray] = {}
        for name, e in evaluator.named_exprs:
            if not name.startswith("key:"):
                aux.update(evaluator.build_aux(e, table.dictionaries))
        return {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in aux.items()}

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

    # -- the fold --------------------------------------------------------------
    def _make_scan_body(self, specs, evaluator, staged, key_plan, capacity, aux):
        """The per-block fold: (states, presence, block, gid_base) ->
        (states, presence). Widens the narrowed int columns, evaluates the
        predicates and gids, masks rows outside this pass's gid window,
        then updates every UDA: the sum-family UDAs and the presence row in
        one fused segment sum (H1), the others through their own update."""
        preds = [e for n, e in evaluator.named_exprs if n.startswith("pred")]
        narrow = [
            (name, torch.tensor(off, dtype=torch.int64))
            for name, off in sorted(staged.narrow_offsets.items())
        ]
        device_key = key_plan.device_expr
        host_gids = key_plan.host_gids is not None

        def body(states, presence, blk: int, gid_base: int):
            env = {name: t[0, blk] for name, t in staged.blocks.items()}
            for name, off in narrow:
                # Widen in int64: torch has no arithmetic on uint16.
                env[name] = env[name].to(torch.int64) + off
            mask = staged.mask[0, blk]
            if host_gids:
                gids = staged.gids[0, blk].to(torch.int32)
            elif device_key is None:
                gids = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
            else:
                gids = evaluator.device_eval(device_key, env, aux).to(torch.int32)
            gids = gids - gid_base
            gid_ok = (gids >= 0) & (gids < capacity)
            gids = torch.clamp(gids, 0, capacity - 1)
            for p in preds:
                mask = mask & evaluator.device_eval(p, env, aux)
            mask = mask & gid_ok

            rows = []
            fused: dict[str, tuple[int, int]] = {}
            for out, arg_e, uda in specs:
                if uda.fused_rows is None:
                    continue
                col = evaluator.device_eval(arg_e, env, aux) if uda.reads_args else None
                r = uda.fused_rows(col, mask)
                fused[out] = (len(rows), len(rows) + len(r))
                rows.extend(r)
            totals = segment.fused_segment_sums(rows, gids, capacity, mask)
            presence = presence + totals[-1]
            new_states = []
            for (out, arg_e, uda), st in zip(specs, states):
                if out in fused:
                    a, b = fused[out]
                    new_states.append(uda.fused_apply(st, totals[a:b]))
                elif not uda.reads_args:
                    new_states.append(uda.update(st, gids, gids, mask=mask))
                else:
                    col = evaluator.device_eval(arg_e, env, aux)
                    new_states.append(uda.update(st, gids, col, mask=mask))
            return new_states, presence

        return body

    def _finalize_pack(self, specs, states, presence) -> list:
        """Finalize on the device where the UDA allows it (device_finalize,
        else finalize): one output tensor per spec, then presence."""
        outs = [
            uda.device_finalize(st) if uda.device_finalize is not None else uda.finalize(st)
            for (_, _, uda), st in zip(specs, states)
        ]
        return outs + [presence]

    def _run_program(self, specs, evaluator, key_plan, staged, aux):
        """Fold every block, pass by pass; returns (([per-spec output],
        presence) as numpy, capacity)."""
        capacity, n_passes = self._pass_plan(specs, key_plan.num_groups)
        body = self._make_scan_body(specs, evaluator, staged, key_plan, capacity, aux)
        per_pass = []
        for p in range(n_passes):
            states = [uda.init(capacity, self.device) for _, _, uda in specs]
            presence = torch.zeros(capacity, dtype=torch.int64, device=self.device)
            for blk in range(staged.num_blocks):
                states, presence = body(states, presence, blk, p * capacity)
            # ONE blocking device -> host copy per pass.
            per_pass.append(_fetch(self._finalize_pack(specs, states, presence)))
        leaves = [np.concatenate(parts, axis=0) for parts in zip(*per_pass)]
        return (leaves[:-1], leaves[-1]), capacity

    def _finalize(self, m, specs, key_plan, outputs, registry) -> RowBatch:
        """Emit only the observed groups (presence > 0), in gid order — the
        dictionary-code order — as the reference's _finalize does."""
        values, presence = outputs
        n = max(key_plan.num_groups, 1) if m.agg_op.groups else 1
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
        for (out_name, _, uda), val in zip(specs, values):
            schema = rel.col(out_name)
            arr = val[:n][keep]
            out = (
                uda.format_output(arr)
                if uda.device_finalize is not None and uda.format_output is not None
                else arr
            )
            if schema.data_type == DataType.STRING:
                d = StringDictionary()
                out_cols.append(DictColumn(d.encode(np.asarray(out, dtype=object)), d))
            else:
                out_cols.append(np.asarray(out, dtype=host_dtype(schema.data_type)))
        return RowBatch(rel, out_cols, eow=True, eos=True)


def _pre_agg_relation(m: _Match, registry):
    return MapOp(
        tuple((name, e) for name, e in m.col_exprs.items())
    ).output_relation([m.source_relation], registry)
