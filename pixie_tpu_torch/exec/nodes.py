"""Source, sink, and row-wise operator nodes.

Ref: src/carnot/exec/{memory_source,memory_sink,empty_source,udtf_source,
map,filter,limit,union}_node.* and grpc_{source,sink}_node.* (bridges).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pixie_tpu_torch.exec.exec_node import ExecNode, SinkNode, SourceNode
from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
from pixie_tpu_torch.plan.operators import (
    BridgeSinkOp,
    BridgeSourceOp,
    EmptySourceOp,
    FilterOp,
    InlineSourceOp,
    LimitOp,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    ResultSinkOp,
    UDTFSourceOp,
    UnionOp,
)
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.table.table import TIME_COLUMN


class MemorySourceNode(SourceNode):
    """Reads a table through a time-bounded cursor (memory_source_node.h:42);
    supports infinite streaming mode (:61)."""

    def __init__(self, op: MemorySourceOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: MemorySourceOp = op
        self._cursor = None
        self._table = None

    def prepare_impl(self, exec_state) -> None:
        self._table = exec_state.table_store.get_table(
            self.op.table_name, self.op.tablet or ""
        )
        if self._table is None:
            raise KeyError(f"no table named {self.op.table_name!r}")
        self._cursor = self._table.cursor(
            self.op.start_time, self.op.stop_time, streaming=self.op.streaming
        )

    def generate_next_impl(self, exec_state) -> bool:
        if self._sent_eos:
            return False
        batch = self._cursor.next_batch()
        done = self._cursor.done()
        if batch is None and not done:
            return False  # streaming: nothing available yet
        if batch is None:
            batch = RowBatch.with_zero_rows(self._table.relation)
        if self.op.column_names is not None:
            batch = batch.select(list(self.op.column_names))
        # Forward STORED end-of-window markers (producers write them per
        # ingest window): windowed aggs downstream emit on them; FULL
        # non-windowed aggs ignore eow, so this is invisible elsewhere
        # (ref: memory_source_node.h streaming flag forwarding).
        self.send(
            exec_state, batch.with_flags(eow=done or batch.eow, eos=done)
        )
        return True


class EmptySourceNode(SourceNode):
    def generate_next_impl(self, exec_state) -> bool:
        if self._sent_eos:
            return False
        self.send(
            exec_state,
            RowBatch.with_zero_rows(self.output_relation, eow=True, eos=True),
        )
        return True


class UDTFSourceNode(SourceNode):
    """Runs a user-defined table function once (udtf_source_node)."""

    def __init__(self, op: UDTFSourceOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: UDTFSourceOp = op

    def generate_next_impl(self, exec_state) -> bool:
        if self._sent_eos:
            return False
        udtf = exec_state.registry.lookup_udtf(self.op.udtf_name)
        data = udtf.fn(exec_state.func_ctx, **dict(self.op.arg_values))
        batch = RowBatch.from_pydict(self.output_relation, data)
        self.send(exec_state, batch.with_flags(eow=True, eos=True))
        return True


class InlineSourceNode(SourceNode):
    """Emits batches stashed in exec_state.inline_batches[key]."""

    def generate_next_impl(self, exec_state) -> bool:
        if self._sent_eos:
            return False
        batches = exec_state.inline_batches.get(self.op.key, [])
        for b in batches:
            self.send(exec_state, b)
        if not batches or not batches[-1].eos:
            self.send(
                exec_state,
                RowBatch.with_zero_rows(self.output_relation, eow=True, eos=True),
            )
        return True


class BridgeSourceNode(SourceNode):
    """Receives batches routed from another fragment
    (ref: grpc_source_node.h:39 + grpc_router.h:53).

    Producer expectations are refreshed from the router mid-query (r9):
    when the broker unregisters a dead agent's bridges (heartbeat expiry
    mid-query, ref query_result_forwarder.go:395), this source stops
    waiting for eos markers that will never arrive and flushes a synthetic
    eos downstream so blocking consumers (merge aggs) finalize with the
    partial input they have."""

    def __init__(self, op: BridgeSourceOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: BridgeSourceOp = op
        self._upstream_eos = 0
        self._expected_producers = 1
        self._had_registrations = False
        self._forwarded_eos = False

    def prepare_impl(self, exec_state) -> None:
        self._expected_producers = exec_state.router.num_producers(
            exec_state.query_id, self.op.bridge_id
        )
        # Raw registration count at prepare: refreshes only apply when at
        # least one producer actually registered — a dangling bridge (no
        # registrations; num_producers floors at 1) must keep the old
        # stall-until-timeout semantics, not silently self-complete.
        count = getattr(exec_state.router, "producer_count", None)
        self._had_registrations = (
            count is not None
            and count(exec_state.query_id, self.op.bridge_id) > 0
        )

    def _refresh_expected(self, exec_state) -> None:
        if not self._had_registrations:
            return
        live = exec_state.router.producer_count(
            exec_state.query_id, self.op.bridge_id
        )
        # Only shrink: registrations all precede fragment launch, so a
        # smaller live count means producers were lost, never added.
        if live < self._expected_producers:
            self._expected_producers = live

    def generate_next_impl(self, exec_state) -> bool:
        # r17: a failover attempt reads through a per-attempt cursor
        # (retained queue) so a replacement consumer re-reads the whole
        # committed stream; None keeps the destructive popleft.
        item = exec_state.router.poll(
            exec_state.query_id,
            self.op.bridge_id,
            consumer=exec_state.bridge_token,
        )
        if item is None:
            self._refresh_expected(exec_state)
            if (
                self._upstream_eos >= self._expected_producers
                and not self._forwarded_eos
            ):
                # Every remaining producer is gone: flush a synthetic eos
                # so downstream blocking ops finalize (partial results).
                self._forwarded_eos = True
                self.send(
                    exec_state,
                    RowBatch.with_zero_rows(
                        self.output_relation, eow=True, eos=True
                    ),
                )
                return True
            return False
        eos = getattr(item, "eos", False)
        if eos:
            self._upstream_eos += 1
            all_done = self._upstream_eos >= self._expected_producers
            if all_done:
                self._forwarded_eos = True
            if isinstance(item, RowBatch):
                item = item.with_flags(eow=all_done and item.eow, eos=all_done)
            else:
                item.eos = all_done
                item.eow = all_done and item.eow
        self.send(exec_state, item)
        return True

    def has_batches_remaining(self) -> bool:
        if self._aborted:
            return False
        if self._upstream_eos < self._expected_producers:
            return True
        # Complete — but if completion came from producer loss (not a real
        # final eos), stay live until the synthetic eos is flushed.
        return not self._forwarded_eos


class MapNode(ExecNode):
    """Vectorized projection (map_node.*): one ExpressionEvaluator pass."""

    def __init__(self, op: MapOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: MapOp = op
        self._evaluator: Optional[ExpressionEvaluator] = None

    def set_input_relation(self, rel, registry, func_ctx=None) -> None:
        self._evaluator = ExpressionEvaluator(
            list(self.op.exprs), rel, registry, func_ctx
        )

    def consume_next_impl(self, exec_state, batch, parent_index) -> None:
        self._evaluator.func_ctx = exec_state.func_ctx
        self._evaluator.device = exec_state.device
        self.send(exec_state, self._evaluator.evaluate(batch, self.output_relation))


class FilterNode(ExecNode):
    def __init__(self, op: FilterOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: FilterOp = op
        self._evaluator: Optional[ExpressionEvaluator] = None

    def set_input_relation(self, rel, registry, func_ctx=None) -> None:
        self._evaluator = ExpressionEvaluator(
            [("pred", self.op.expr)], rel, registry, func_ctx
        )

    def consume_next_impl(self, exec_state, batch, parent_index) -> None:
        self._evaluator.func_ctx = exec_state.func_ctx
        self._evaluator.device = exec_state.device
        if batch.num_rows:
            mask = self._evaluator.evaluate_predicate(batch)
            if not mask.all():
                batch = batch.take(np.nonzero(mask)[0])
        self.send(exec_state, batch)


class LimitNode(ExecNode):
    """Row limit; aborts upstream sources once satisfied (limit_node.*,
    annotate_abortable_sources_for_limits_rule)."""

    def __init__(self, op: LimitOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: LimitOp = op
        self._seen = 0
        self._done = False
        # Sources whose every path to a sink passes through this limit;
        # filled by ExecutionGraph init (ref: the planner's
        # annotate_abortable_sources_for_limits_rule).
        self.abortable_sources: list = []

    def consume_next_impl(self, exec_state, batch, parent_index) -> None:
        if self._done:
            return
        remaining = self.op.n - self._seen
        out = batch
        if batch.num_rows > remaining:
            out = batch.slice(0, remaining)
        self._seen += out.num_rows
        if self._seen >= self.op.n:
            self._done = True
            out = out.with_flags(eow=True, eos=True)
            for src in self.abortable_sources:
                src.abort()
        self.send(exec_state, out)


class UnionNode(ExecNode):
    """k-way union. With a time_ column, performs an incremental time-ordered
    merge: on every batch, rows up to the minimum high-watermark time across
    still-live parents are merged and emitted (the reference union_node's
    streaming ordered merge) — so streaming queries make progress and the
    buffer stays bounded. Without a time column, batches pass through and eos
    waits for all parents."""

    def __init__(self, op: UnionOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: UnionOp = op
        self._num_parents = 1
        self._eos_seen = 0
        self._buffer: list[RowBatch] = []  # new, not-yet-sorted batches
        self._sorted_rest: Optional[RowBatch] = None  # retained sorted run
        self._ordered = False
        self._incremental = True
        self._watermarks: list = []
        self._parent_eos: list = []
        self._pending_min = None  # min buffered time: cheap no-op guard

    def prepare_impl(self, exec_state) -> None:
        self._num_parents = len(getattr(self, "parent_nodes", [None]))
        self._ordered = self.output_relation.has_column(TIME_COLUMN)
        self._watermarks = [None] * self._num_parents
        self._parent_eos = [False] * self._num_parents
        # Incremental emission is only sound when every parent stream is
        # time-nondecreasing. That is a *plan* property: decide it up front
        # by walking each parent's ancestry — joins reorder rows (unmatched
        # rows trail matched ones), so any union fed by a join buffers until
        # eos and sorts globally (ADVICE r2 medium: a runtime watermark
        # check alone cannot restore order once rows have been emitted).
        self._incremental = self._ancestry_order_preserving()

    def _ancestry_order_preserving(self) -> bool:
        """True iff every ancestor declares preserves_time_order. Bridge
        sources have no visible ancestry, but the distributed splitter cuts
        plans *before* blocking ops (splitter.h:52) so upstream fragments
        contain only order-preserving ops; the runtime monotonicity guard
        covers anything that violates that invariant anyway."""
        stack = list(getattr(self, "parent_nodes", []) or [])
        seen: set = set()
        while stack:
            node = stack.pop()
            if node is None or id(node) in seen:
                continue
            seen.add(id(node))
            if not getattr(node, "preserves_time_order", True):
                return False
            stack.extend(getattr(node, "parent_nodes", []) or [])
        return True

    def consume_next_impl(self, exec_state, batch, parent_index) -> None:
        eos = batch.eos
        if self._ordered:
            if batch.num_rows:
                self._buffer.append(batch)
                times = np.asarray(batch.col(TIME_COLUMN))
                tmin = times.min()
                tmax = times.max()
                # Defense-in-depth for streams the plan walk can't see
                # through (e.g. a reordering op beyond a bridge): a batch
                # that is internally unsorted or starts before its parent's
                # watermark flips us to the buffer-until-eos global sort.
                # Best-effort only — it cannot recall rows already emitted.
                if self._incremental:
                    prev = self._watermarks[parent_index]
                    if (prev is not None and tmin < prev) or (
                        batch.num_rows > 1
                        and np.any(times[1:] < times[:-1])
                    ):
                        self._incremental = False
                self._watermarks[parent_index] = (
                    tmax
                    if self._watermarks[parent_index] is None
                    else max(self._watermarks[parent_index], tmax)
                )
                self._pending_min = (
                    tmin
                    if self._pending_min is None
                    else min(self._pending_min, tmin)
                )
            if eos:
                self._parent_eos[parent_index] = True
                self._eos_seen += 1
            if self._eos_seen >= self._num_parents:
                self._flush(exec_state)
            elif self._incremental:
                self._emit_ready(exec_state)
            return
        if batch.num_rows:
            self.send(exec_state, batch.with_flags(eow=False, eos=False))
        if eos:
            self._eos_seen += 1
            if self._eos_seen >= self._num_parents:
                self.send(
                    exec_state,
                    RowBatch.with_zero_rows(
                        self.output_relation, eow=True, eos=True
                    ),
                )

    def _merged_pending(self) -> Optional[RowBatch]:
        """Sort only the new batches, then linear-merge with the retained
        sorted run — avoids re-sorting the whole buffer per batch when one
        parent lags (the remainder can grow large)."""
        new = None
        if self._buffer:
            new = RowBatch.concat(self._buffer)
            order = np.argsort(np.asarray(new.col(TIME_COLUMN)), kind="stable")
            new = new.take(order)
        self._buffer = []
        rest = self._sorted_rest
        self._sorted_rest = None
        if rest is None or not rest.num_rows:
            return new
        if new is None or not new.num_rows:
            return rest
        a = np.asarray(rest.col(TIME_COLUMN))
        b = np.asarray(new.col(TIME_COLUMN))
        # Interleave two sorted runs: each b-row lands after the a-rows that
        # precede it (stable: ties keep rest before new).
        b_pos = np.searchsorted(a, b, side="right") + np.arange(len(b))
        total = len(a) + len(b)
        mask = np.ones(total, dtype=bool)
        mask[b_pos] = False
        perm = np.empty(total, dtype=np.int64)
        perm[np.nonzero(mask)[0]] = np.arange(len(a))
        perm[b_pos] = len(a) + np.arange(len(b))
        return RowBatch.concat([rest, new]).take(perm)

    def _emit_ready(self, exec_state) -> None:
        """Emit rows with time strictly below the min watermark of live
        parents — later rows from those parents can still sort before
        anything at/after it (per-parent batches arrive time-ordered)."""
        live = [
            self._watermarks[i]
            for i in range(self._num_parents)
            if not self._parent_eos[i]
        ]
        if any(w is None for w in live):
            return  # a live parent hasn't produced yet: no safe cutoff
        cutoff = min(live) if live else None
        if cutoff is None or (
            self._pending_min is None or self._pending_min >= cutoff
        ):
            return  # nothing can be ready: skip the concat+sort entirely
        merged = self._merged_pending()
        if merged is None:
            return
        times = np.asarray(merged.col(TIME_COLUMN))
        n_ready = int(np.searchsorted(times, cutoff, side="left"))
        if n_ready == 0:
            self._sorted_rest = merged  # keep the merged run for next time
            return
        self.send(
            exec_state,
            merged.slice(0, n_ready).with_flags(eow=False, eos=False),
        )
        rest = merged.slice(n_ready, merged.num_rows)
        self._sorted_rest = rest if rest.num_rows else None
        self._pending_min = times[n_ready] if rest.num_rows else None

    def _flush(self, exec_state) -> None:
        merged = self._merged_pending()
        if merged is not None:
            self.send(exec_state, merged.with_flags(eow=True, eos=True))
        else:
            self.send(
                exec_state,
                RowBatch.with_zero_rows(self.output_relation, eow=True, eos=True),
            )
        self._buffer = []
        self._sorted_rest = None


class MemorySinkNode(SinkNode):
    """Collects results into an in-memory output table (memory_sink_node)."""

    def __init__(self, op: MemorySinkOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: MemorySinkOp = op
        self.batches: list[RowBatch] = []

    def consume_next_impl(self, exec_state, batch, parent_index) -> None:
        self.batches.append(batch)


class ResultSinkNode(SinkNode):
    """Streams result batches to the query's result destination
    (ref: grpc_sink external mode → TransferResultChunk)."""

    def __init__(self, op: ResultSinkOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: ResultSinkOp = op

    def consume_next_impl(self, exec_state, batch, parent_index) -> None:
        if exec_state.result_callback is not None:
            exec_state.result_callback(self.op.table_name, batch)


class BridgeSinkNode(SinkNode):
    """Sends batches (row or state) to a bridge for another fragment
    (ref: grpc_sink_node.h:54 internal mode)."""

    def __init__(self, op: BridgeSinkOp, output_relation, node_id):
        super().__init__(op, output_relation, node_id)
        self.op: BridgeSinkOp = op
        self._pushed_eos = False

    def consume_next_impl(self, exec_state, batch, parent_index) -> None:
        if getattr(batch, "eos", False):
            self._pushed_eos = True
        exec_state.router.push(
            exec_state.query_id,
            self.op.bridge_id,
            batch,
            token=exec_state.bridge_token,
        )

    def flush_cancel(self, exec_state) -> None:
        """On fragment abort (stall/deadline, r9): if no eos crossed this
        bridge yet, push a zero-row eos marker so the consumer fragment
        finalizes with partial input instead of stalling to its own
        timeout waiting on a producer that aborted. A failover attempt
        (r17) skips the flush: committing an empty stream would WIN the
        slot and lock the retry out — the broker's revoke/replace covers
        the consumer instead."""
        if self._pushed_eos:
            return
        self._pushed_eos = True
        if exec_state.bridge_token is not None:
            return
        exec_state.router.push(
            exec_state.query_id,
            self.op.bridge_id,
            RowBatch.with_zero_rows(self.output_relation, eow=True, eos=True),
        )
