"""ExecutionGraph — builds the node DAG from a plan fragment and runs it.

Ref: src/carnot/exec/exec_graph.{h,cc} — Init (:52) instantiates ExecNodes
from plan operators and wires children; Execute (:295) round-robins sources
(ExecuteSources :177), each source generating up to
``consecutive_generate_calls_per_source`` batches per turn, pushing batches
depth-first through ConsumeNext; when no source can progress the loop yields
with a timeout (waiting on bridge data or table activity); limits abort
sources via exec_state.

Aggregations the DeviceExecutor does not take run on the AggNode
(exec/agg_node.py), whose states live on the engine's device; joins it does
not take run on the EquijoinNode (exec/join_node.py).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from pixie_tpu_torch.exec.agg_node import AggNode
from pixie_tpu_torch.exec.exec_node import ExecNode
from pixie_tpu_torch.exec.join_node import EquijoinNode
from pixie_tpu_torch.exec.nodes import (
    BridgeSinkNode,
    BridgeSourceNode,
    EmptySourceNode,
    FilterNode,
    InlineSourceNode,
    LimitNode,
    MapNode,
    MemorySinkNode,
    MemorySourceNode,
    ResultSinkNode,
    UDTFSourceNode,
    UnionNode,
)
from pixie_tpu_torch.exec.otel_sink_node import OTelExportSinkNode
from pixie_tpu_torch.plan.operators import (
    AggOp,
    BridgeSinkOp,
    BridgeSourceOp,
    EmptySourceOp,
    FilterOp,
    InlineSourceOp,
    JoinOp,
    LimitOp,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    OTelExportSinkOp,
    ResultSinkOp,
    UDTFSourceOp,
    UnionOp,
)
from pixie_tpu_torch.plan.plan import PlanFragment

CONSECUTIVE_GENERATE_CALLS_PER_SOURCE = 8  # ref: exec_graph.cc source fairness
DEFAULT_YIELD_S = 0.001

from pixie_tpu_torch.utils import define_flag, flags as _flags  # noqa: E402

define_flag(
    "exec_source_stall_s",
    30.0,
    help_="Seconds a fragment waits on stalled sources (bridge data / "
    "table activity) before failing the query (ref: exec_graph.cc "
    "source health checks).",
)

_NODE_TYPES = {
    MemorySourceOp: MemorySourceNode,
    InlineSourceOp: InlineSourceNode,
    EmptySourceOp: EmptySourceNode,
    UDTFSourceOp: UDTFSourceNode,
    BridgeSourceOp: BridgeSourceNode,
    MapOp: MapNode,
    FilterOp: FilterNode,
    LimitOp: LimitNode,
    UnionOp: UnionNode,
    AggOp: AggNode,
    JoinOp: EquijoinNode,
    MemorySinkOp: MemorySinkNode,
    ResultSinkOp: ResultSinkNode,
    BridgeSinkOp: BridgeSinkNode,
    OTelExportSinkOp: OTelExportSinkNode,
}


class ExecutionGraph:
    def __init__(self, fragment: PlanFragment, exec_state):
        self.fragment = fragment
        self.exec_state = exec_state
        self.nodes: dict[int, ExecNode] = {}
        self.sources: list[ExecNode] = []
        self.sinks: list[ExecNode] = []
        self._init()

    # -- init (ref: ExecutionGraph::Init, exec_graph.cc:52) -----------------
    def _init(self) -> None:
        st = self.exec_state
        table_rel = lambda op: st.table_store.get_relation(op.table_name)
        relations = self.fragment.resolve_relations(st.registry, table_rel)
        for nid in self.fragment.topo_order():
            op = self.fragment.node(nid)
            node_cls = _NODE_TYPES.get(type(op))
            if node_cls is None:
                raise ValueError(f"no exec node for operator {op!r}")
            node = node_cls(op, relations[nid], nid)
            parents = self.fragment.parents(nid)
            node.parent_nodes = [self.nodes[p] for p in parents]
            for slot, p in enumerate(parents):
                self.nodes[p].add_child(node, slot)
            # Resolve input relations for expression-bearing nodes.
            if isinstance(node, (MapNode, FilterNode)):
                node.set_input_relation(relations[parents[0]], st.registry)
            elif isinstance(node, AggNode):
                node.set_input_relation(relations[parents[0]], st.registry)
            elif isinstance(node, EquijoinNode):
                node.set_input_relations(
                    relations[parents[0]], relations[parents[1]]
                )
            self.nodes[nid] = node
            if node.is_source:
                self.sources.append(node)
            if node.is_sink:
                self.sinks.append(node)
        for node in self.nodes.values():
            node.init(st)
        self._annotate_abortable_sources()

    def _annotate_abortable_sources(self) -> None:
        """For each limit, find sources whose every path to a sink passes
        through it (ref: annotate_abortable_sources_for_limits_rule): remove
        the limit from the graph; a source that can no longer reach any sink
        is abortable."""
        limit_nodes = [n for n in self.nodes.values() if isinstance(n, LimitNode)]
        sink_ids = set(self.fragment.sinks())
        for lim in limit_nodes:
            for src in self.sources:
                if self._reaches_sink_without(src.node_id, lim.node_id, sink_ids):
                    continue
                lim.abortable_sources.append(src)

    def _reaches_sink_without(self, start: int, blocked: int, sinks: set) -> bool:
        seen = set()
        stack = [start]
        while stack:
            nid = stack.pop()
            if nid == blocked or nid in seen:
                continue
            seen.add(nid)
            if nid in sinks:
                return True
            stack.extend(self.fragment.children(nid))
        return False

    # -- execute (ref: ExecutionGraph::Execute, exec_graph.cc:295) ----------
    def execute(
        self,
        timeout_s: Optional[float] = None,
        yield_fn: Optional[Callable[[], None]] = None,
    ) -> None:
        if timeout_s is None:
            # Read at call time so flags.set()/env changes after import
            # still apply.
            timeout_s = _flags.exec_source_stall_s
        st = self.exec_state
        order = self.fragment.topo_order()
        for nid in order:
            self.nodes[nid].prepare(st)
        for nid in order:
            self.nodes[nid].open(st)
        try:
            self._execute_sources(timeout_s, yield_fn)
        finally:
            for nid in reversed(order):
                self.nodes[nid].close(st)
            self._emit_node_spans()

    def _emit_node_spans(self) -> None:
        """Per-exec-node trace spans (r11): one span per operator node
        carrying its lifetime self-time and rows/batches in/out — emitted
        once at fragment end (never per batch, so the hot ConsumeNext
        path pays nothing). Parented to the fragment span captured in the
        exec state's trace context."""
        from pixie_tpu_torch.utils import trace

        tctx = getattr(self.exec_state, "trace_ctx", None)
        if not trace.ACTIVE or not tctx:
            return
        for node in self.nodes.values():
            s = node.stats
            trace.record(
                f"exec:{node.name}",
                s.self_time_ns,
                trace_id=tctx[0],
                parent_id=tctx[1],
                instance=self.exec_state.instance,
                attrs={
                    "rows_in": s.rows_in,
                    "rows_out": s.rows_out,
                    "batches_in": s.batches_in,
                    "batches_out": s.batches_out,
                    "bytes_in": s.bytes_in,
                    "bytes_out": s.bytes_out,
                },
            )

    def _execute_sources(self, timeout_s, yield_fn) -> None:
        """Round-robin source loop (ref: ExecuteSources, exec_graph.cc:177).

        Two clocks (r9): the STALL deadline resets whenever any source
        makes progress (source-health watchdog); the exec state's HARD
        deadline, propagated broker→agent, never resets — a fragment that
        keeps trickling batches past the query deadline still aborts, so a
        stalled query dies everywhere, not just at the client."""
        deadline = time.monotonic() + timeout_s
        running = list(self.sources)
        while running:
            if not self.exec_state.keep_running:
                break  # a limit aborted the sources / query was cancelled
            if self.exec_state.deadline_exceeded():
                self._abort("query deadline exceeded")
                self.exec_state.check_deadline()  # raises
            progressed = False
            for src in list(running):
                for _ in range(CONSECUTIVE_GENERATE_CALLS_PER_SOURCE):
                    if not self.exec_state.keep_running:
                        break
                    if not src.has_batches_remaining():
                        break
                    if not src.generate_next(self.exec_state):
                        break
                    progressed = True
                if not src.has_batches_remaining():
                    running.remove(src)
            if not running:
                break
            if not progressed:
                # Yield: wait for bridge/table data (ref: YieldWithTimeout).
                if time.monotonic() > deadline:
                    stalled = [s.name for s in running]
                    self._abort(f"sources stalled ({stalled})")
                    raise TimeoutError(
                        f"query {self.exec_state.query_id}: sources stalled "
                        f"({stalled})"
                    )
                if yield_fn is not None:
                    yield_fn()
                else:
                    time.sleep(DEFAULT_YIELD_S)
            else:
                deadline = time.monotonic() + timeout_s

    def _abort(self, reason: str) -> None:
        """Source-stall/deadline abort: propagate cancellation to sibling
        nodes (keep_running goes false, every source is abort()ed) and
        flush eos through bridge sinks so consumer fragments parked on the
        router aren't left waiting for markers that will never come (r9;
        ref: the forwarder's cancel path, query_result_forwarder.go:571)."""
        st = self.exec_state
        st.cancel(reason)
        for src in self.sources:
            src.abort()
        for node in self.nodes.values():
            if isinstance(node, BridgeSinkNode):
                try:
                    node.flush_cancel(st)
                except Exception:
                    pass  # router may already be torn down

    # -- stats (ref: exec_node.h:60-128 per-op stats; carnot.cc:369-399) ----
    def stats(self) -> dict:
        return {
            node.name: node.stats.to_dict() for node in self.nodes.values()
        }

    def result_batches(self) -> dict[str, list]:
        """Batches collected by MemorySink nodes, keyed by sink name."""
        out = {}
        for node in self.sinks:
            if isinstance(node, MemorySinkNode):
                out[node.op.name] = node.batches
        return out
