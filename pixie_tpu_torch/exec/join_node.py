"""Hash equijoin node.

Ref: src/carnot/exec/equijoin_node.{h,cc} — build/probe hash join with
RowTuple keys over inner/left/right/outer, chunked output. The reference
probes row-at-a-time into an absl map; ours vectorizes: build-side keys
densify through a GroupEncoder (one np.unique per batch), probe batches
resolve via the same encoder's lookup, and the gather/emit is columnar.
Joins on telemetry joins (service×service, upid×upid) are low-cardinality,
so the build table is small; the probe side streams.

Build side = left input (parent 0), probe side = right (parent 1) — the
planner orders inputs so the smaller relation is left (same convention as
the reference's specified build side).

Port of pixie_tpu/exec/join_node.py, which imports no JAX: the same numpy
code, without the reference's cost-model hooks (the port has no cost model;
the reference with its model inactive runs exactly this). Joins that the
DeviceExecutor's sort-merge lane declines run here, bit-identical to it for
INNER and LEFT and the same rows for RIGHT and OUTER.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pixie_tpu_torch.exec.exec_node import ExecNode
from pixie_tpu_torch.exec.group_encoder import GroupEncoder
from pixie_tpu_torch.plan.operators import JoinOp, JoinType
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import Relation

OUTPUT_CHUNK_ROWS = 1 << 17

class EquijoinNode(ExecNode):
    # Matched probe rows are emitted before (possibly earlier-timed)
    # RIGHT/OUTER-unmatched rows: output is not time-ordered.
    preserves_time_order = False

    def __init__(self, op: JoinOp, output_relation: Relation, node_id: int):
        super().__init__(op, output_relation, node_id)
        self.op: JoinOp = op
        self._encoder = GroupEncoder()
        self._build_batches: list[RowBatch] = []
        self._build_done = False
        self._build: Optional[RowBatch] = None
        self._build_counts: np.ndarray = np.empty(0, np.int64)
        self._build_order: np.ndarray = np.empty(0, np.int64)
        self._build_starts: np.ndarray = np.zeros(1, np.int64)
        self._build_matched: Optional[np.ndarray] = None
        self._pending_probe: list[RowBatch] = []
        self._probe_eos = False
        self._left_relation: Optional[Relation] = None
        self._right_relation: Optional[Relation] = None

    def set_input_relations(self, left: Relation, right: Relation) -> None:
        self._left_relation = left
        self._right_relation = right

    def consume_next_impl(self, exec_state, batch, parent_index: int) -> None:
        if parent_index == 0:
            self._consume_build(exec_state, batch)
        else:
            self._consume_probe(exec_state, batch)

    # -- build --------------------------------------------------------------
    def _consume_build(self, exec_state, batch: RowBatch) -> None:
        if batch.num_rows:
            self._build_batches.append(batch)
        if batch.eos:
            self._finish_build()
            for pb in self._pending_probe:
                self._probe(exec_state, pb)
            self._pending_probe = []
            if self._probe_eos:
                self._finish(exec_state)

    def _finish_build(self) -> None:
        self._build_done = True
        if self._build_batches:
            self._build = RowBatch.concat(self._build_batches)
        else:
            self._build = RowBatch.with_zero_rows(self._left_relation)
        self._build_batches = []
        keys = [self._build.col(k) for k in self.op.left_on]
        if self._build.num_rows:
            gids = self._encoder.encode(keys)
        else:
            gids = np.empty(0, np.int32)
        # CSR layout over build rows grouped by gid: rows of group g are
        # _build_order[_build_starts[g] : _build_starts[g+1]], in build
        # order (stable sort) — the vectorized stand-in for the reference's
        # per-key bucket vectors (equijoin_node.h:48).
        n_groups = self._encoder.num_groups
        self._build_counts = np.bincount(gids, minlength=n_groups).astype(
            np.int64
        )
        self._build_order = np.argsort(gids, kind="stable")
        self._build_starts = np.concatenate(
            [[0], np.cumsum(self._build_counts)]
        )
        self._build_matched = np.zeros(self._build.num_rows, dtype=bool)

    # -- probe --------------------------------------------------------------
    def _consume_probe(self, exec_state, batch: RowBatch) -> None:
        if not self._build_done:
            if batch.num_rows:
                self._pending_probe.append(batch)
            if batch.eos:
                self._probe_eos = True
            return
        if batch.num_rows:
            self._probe(exec_state, batch)
        if batch.eos:
            self._probe_eos = True
            self._finish(exec_state)

    def _probe(self, exec_state, batch: RowBatch) -> None:
        keys = []
        for k, bk in zip(self.op.right_on, self.op.left_on):
            col = batch.col(k)
            # Align probe string codes into the build dictionary space.
            if isinstance(col, DictColumn):
                build_col = self._build.col(bk)
                if (
                    isinstance(build_col, DictColumn)
                    and build_col.dictionary is not col.dictionary
                ):
                    col = DictColumn(
                        build_col.dictionary.encode(col.decode()),
                        build_col.dictionary,
                    )
            keys.append(col)
        gids = np.asarray(self._encoder.lookup(keys), dtype=np.int64)
        n_groups = len(self._build_counts)
        if n_groups == 0:
            matched = np.zeros(len(gids), dtype=bool)
            fanout = np.zeros(len(gids), dtype=np.int64)
        else:
            g_safe = np.clip(gids, 0, n_groups - 1)
            matched = gids >= 0
            fanout = np.where(matched, self._build_counts[g_safe], 0)
            matched = matched & (fanout > 0)
            fanout = np.where(matched, fanout, 0)
        total = int(fanout.sum())
        if total:
            # probe row i pairs with build rows order[starts[g_i] + 0..c_i-1]
            right_idx = np.repeat(np.arange(len(gids)), fanout)
            run_base = np.repeat(np.cumsum(fanout) - fanout, fanout)
            ramp = np.arange(total) - run_base
            left_idx = self._build_order[
                self._build_starts[g_safe][right_idx] + ramp
            ]
            self._build_matched[left_idx] = True
            self._emit_matches(
                exec_state,
                self._build.take(left_idx),
                batch.take(right_idx),
            )
        unmatched = np.nonzero(~matched)[0]
        if len(unmatched) and self.op.how in (JoinType.RIGHT, JoinType.OUTER):
            right_part = batch.take(unmatched)
            self._emit_matches(
                exec_state,
                _null_batch(self._left_relation, right_part.num_rows),
                right_part,
            )

    def _finish(self, exec_state) -> None:
        if self._sent_eos:
            return
        if self.op.how in (JoinType.LEFT, JoinType.OUTER) and self._build is not None:
            unmatched = np.nonzero(~self._build_matched)[0]
            if len(unmatched):
                left_part = self._build.take(unmatched)
                self._emit_matches(
                    exec_state,
                    left_part,
                    _null_batch(self._right_relation, left_part.num_rows),
                )
        self.send(
            exec_state,
            RowBatch.with_zero_rows(self.output_relation, eow=True, eos=True),
        )

    def _emit_matches(self, exec_state, left: RowBatch, right: RowBatch) -> None:
        cols = []
        for side, in_name, _ in self.op.output_columns:
            src = left if side == 0 else right
            cols.append(src.col(in_name))
        for off in range(0, left.num_rows, OUTPUT_CHUNK_ROWS):
            hi = min(off + OUTPUT_CHUNK_ROWS, left.num_rows)
            chunk = [
                c.slice(off, hi) if isinstance(c, DictColumn) else c[off:hi]
                for c in cols
            ]
            self.send(exec_state, RowBatch(self.output_relation, chunk))


def _null_batch(relation: Relation, n: int) -> RowBatch:
    """All-default rows for outer-join padding (ref: the reference emits
    type-default values for unmatched sides)."""
    data = {}
    from pixie_tpu_torch.types import DataType

    for c in relation:
        if c.data_type == DataType.STRING:
            data[c.name] = np.full(n, "", dtype=object)
        else:
            data[c.name] = np.zeros(n, dtype=None)
    return RowBatch.from_pydict(relation, data)
