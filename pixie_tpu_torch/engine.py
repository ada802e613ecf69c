"""Carnot-equivalent engine facade.

Ref: src/carnot/carnot.{h,cc} — Carnot::Create (carnot.h:52),
ExecuteQuery (carnot.cc:122; compile then execute), ExecutePlan
(carnot.cc:319; walk fragments, build exec graphs, run, stream results +
per-operator stats to the result destination).

Port of pixie_tpu/engine.py. A ``device_executor`` (pixie_tpu_torch.parallel.
DeviceExecutor) takes the fragments whose aggregation runs on the device;
the host exec graph runs the rest, its AggNode's states on the executor's
device, or without an executor on ``device`` (None: the CUDA card, resolved
when an AggNode first prepares). The self-telemetry tables are not here:
ingest is not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Optional

from pixie_tpu_torch.compiler import Compiler
from pixie_tpu_torch.exec import BridgeRouter, ExecState, ExecutionGraph
from pixie_tpu_torch.plan.operators import BridgeSinkOp, InlineSourceOp
from pixie_tpu_torch.plan.plan import Plan, PlanFragment
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.table.table_store import TableStore
from pixie_tpu_torch.utils import trace


@dataclasses.dataclass
class QueryResult:
    """Streamed result tables + execution stats (ref: queryresultspb)."""

    query_id: str
    tables: dict[str, list[RowBatch]]
    exec_stats: dict[str, dict]  # node name -> stats dict (analyze mode)
    compile_time_ns: int = 0
    exec_time_ns: int = 0
    # Structured partial-result annotation (r9; ref: the forwarder's
    # per-agent timeout/cancel annotations, query_result_forwarder.go:395):
    # None = complete result. Otherwise a dict with keys ``partial``,
    # ``reasons``, ``agent_errors`` {agent: message}, ``lost_agents``
    # (heartbeat-expired mid-query), ``timed_out_agents`` (still pending at
    # the deadline), ``skipped_agents`` (planning never covered them),
    # ``skipped`` (r10: [{agent_id, reason}] with reason
    # ``heartbeat_expired`` or ``breaker_open``), ``forward_dropped``
    # (result messages lost in the broker's forwarder), ``trace_id``
    # (r11: joins the annotation to the query's span tree).
    degraded: Optional[dict] = None
    # Finished trace spans for this query (r11), merged across agents by
    # trace_id — wire-shaped dicts (utils/trace.py Span.to_dict). None
    # when query_tracing is off.
    trace_spans: Optional[list] = None
    # Transparent-failover annotation (r17, flag ``fragment_failover``):
    # set when the result is COMPLETE but one or more fragments had to be
    # retried onto a surviving agent or won by a hedged duplicate —
    # {"retried": [{slot, from, to, reason, epoch}], "hedged": [{slot,
    # winner, loser}], "trace_id"}. A recovered result is NOT degraded
    # (``ok`` stays True): the rows are bit-identical to an unfaulted
    # run; the annotation only says failover did work to get them.
    recovered: Optional[dict] = None
    # Materialized-view freshness stamp (r20, flag ``materialized_views``):
    # set when the result was served from a view's merged partial-agg
    # state instead of a fold — {"view", "view_id", "staleness_s"
    # (seconds since the view's last successful maintenance),
    # "watermark" (table row-id the carried state covers), "tail_rows"
    # (unflushed rows delta-folded at read time)}. A view-served result
    # is bit-identical to folding from scratch; the stamp only says how
    # the rows were produced and how fresh the carried state was.
    view: Optional[dict] = None

    @property
    def ok(self) -> bool:
        """True when the result is complete (no degraded annotation)."""
        return self.degraded is None

    @property
    def profile(self) -> Optional[dict]:
        """The assembled query trace (r11): a span forest covering
        broker, every participating agent, each exec node, and per-window
        device phases — with degraded agents marked. None when tracing
        was off for the query."""
        if self.trace_spans is None:
            return None
        roots = trace.build_tree(self.trace_spans)
        agents = sorted(
            {
                s["instance"]
                for s in self.trace_spans
                if s.get("name") == "agent.execute"
            }
        )
        out = {
            "trace_id": self.query_id,
            "span_count": len(self.trace_spans),
            "agents": agents,
            "roots": roots,
        }
        if self.degraded is not None:
            # Mark agents whose span subtree is missing or truncated.
            out["degraded"] = {
                "reasons": list(self.degraded.get("reasons", ())),
                "lost_agents": list(self.degraded.get("lost_agents", ())),
                "timed_out_agents": list(
                    self.degraded.get("timed_out_agents", ())
                ),
                "skipped_agents": list(
                    self.degraded.get("skipped_agents", ())
                ),
                "error_agents": sorted(
                    self.degraded.get("agent_errors", {})
                ),
            }
        return out

    def table(self, name: str = None) -> dict:
        if name is None:
            if len(self.tables) != 1:
                raise KeyError(f"result has tables {sorted(self.tables)}")
            name = next(iter(self.tables))
        batches = [b for b in self.tables[name] if b.num_rows]
        if not batches:
            return {}
        return RowBatch.concat(batches).to_pydict()


def _splice_inline_source(
    fragment: PlanFragment, agg_nid: int, key: str, relation
) -> PlanFragment:
    """Replace the device-executed prefix (agg + its ancestors) with an
    InlineSource emitting the computed aggregate, keeping the suffix."""
    ancestors = set()
    stack = list(fragment.parents(agg_nid))
    while stack:
        p = stack.pop()
        if p not in ancestors:
            ancestors.add(p)
            stack.extend(fragment.parents(p))
    new = PlanFragment(fragment.fragment_id)
    mapping: dict[int, int] = {}
    mapping[agg_nid] = new.add(InlineSourceOp(key=key, relation=relation))
    for nid in fragment.topo_order():
        if nid == agg_nid or nid in ancestors:
            continue
        mapping[nid] = new.add(
            fragment.node(nid), [mapping[p] for p in fragment.parents(nid)]
        )
    return new


class Carnot:
    """One engine instance (a PEM or Kelvin equivalent runs one of these)."""

    def __init__(
        self,
        table_store: Optional[TableStore] = None,
        registry=None,
        metadata_state=None,
        router: Optional[BridgeRouter] = None,
        instance: str = "local",
        device_executor=None,
        vizier_ctx=None,
        otel_exporter=None,
        device=None,
    ):
        self.table_store = table_store or TableStore()
        self.vizier_ctx = vizier_ctx
        # Default exporter: BOUNDED in-memory collector (zero-egress
        # default; long-lived engines with recurring exports must not leak
        # — swap in an OTLP/HTTP callable for a real collector).
        import collections

        self.otel_payloads: "collections.deque" = collections.deque(
            maxlen=1024
        )
        self.otel_exporter = otel_exporter or self.otel_payloads.append
        if registry is None:
            from pixie_tpu_torch.udf.registry import default_registry

            registry = default_registry()
        self.registry = registry
        self.metadata_state = metadata_state
        self.router = router or BridgeRouter()
        self.instance = instance
        # Optional pixie_tpu_torch.parallel.DeviceExecutor: fragments
        # matching the source→map/filter→agg chain fold on the device; the
        # host exec graph runs the suffix.
        self.device_executor = device_executor
        if device_executor is not None and hasattr(device_executor, "enable_resident_ingest"):
            # With flag ``resident_ingest``, every created table gets a device
            # ring fed by its appends (serving/resident.py), so a hot table
            # never cold-stages its full windows (pixie_tpu/engine.py:203).
            self.table_store.add_create_listener(
                lambda name, table: device_executor.enable_resident_ingest(table)
            )
        # Where the host AggNode keeps its states without a device executor
        # ("cpu" for the plain versions; None: CUDA, resolved on first use).
        self.device = device
        self.compiler = Compiler(registry)
        # Live per-query exec states (r17): lets the broker's hedge path
        # cancel a losing duplicate mid-flight through the r9 abort
        # machinery (ExecState.cancel → keep_running False → sources
        # abort) instead of letting it run to completion. Cancellation
        # is ATTEMPT-scoped: one engine may host several attempts of
        # the same query (a hedged merge landing on the straggler's own
        # agent), and cancelling the loser must not touch its
        # co-resident siblings.
        self._active_lock = threading.Lock()
        self._active_states: dict[str, list] = {}
        import collections as _collections

        self._cancelled_attempts: set = set()
        self._cancelled_order: "_collections.deque" = _collections.deque()

    def cancel_query(self, query_id: str, token=None) -> None:
        """Cancel live exec states of ``query_id`` on this engine (r17
        hedge-loser cancellation; also usable by embedders). With
        ``token`` (a failover attempt's (slot, epoch)), only that
        attempt's states cancel. A query with no live state is a no-op
        — cancellation is advisory, exactly-once delivery never depends
        on it; the mark persists so an attempt cancelled between
        fragments stops (and withholds its output) too."""
        with self._active_lock:
            self._cancelled_attempts.add((query_id, token))
            self._cancelled_order.append((query_id, token))
            while len(self._cancelled_order) > 1024:
                self._cancelled_attempts.discard(
                    self._cancelled_order.popleft()
                )
            states = [
                st
                for st in self._active_states.get(query_id, ())
                if token is None or st.bridge_token == token
            ]
        for st in states:
            st.cancel("cancelled by broker (hedge loser / failover)")

    def attempt_cancelled(self, query_id: str, token) -> bool:
        """True when this (query, attempt) was cancelled by the broker:
        the attempt must WITHHOLD its output — another attempt won the
        slot, and partial rows from an aborted run must never look like
        a completed fragment."""
        with self._active_lock:
            return (query_id, token) in self._cancelled_attempts or (
                (query_id, None) in self._cancelled_attempts
            )

    def _track_state(self, query_id: str, state) -> None:
        with self._active_lock:
            self._active_states.setdefault(query_id, []).append(state)

    def _untrack_states(self, query_id: str, states: list) -> None:
        with self._active_lock:
            kept = [
                st
                for st in self._active_states.get(query_id, ())
                if st not in states
            ]
            if kept:
                self._active_states[query_id] = kept
            else:
                self._active_states.pop(query_id, None)

    # -- the two entry points (carnot.h:72-81) ------------------------------
    def execute_query(
        self,
        query: str,
        query_id: Optional[str] = None,
        analyze: bool = False,
        now_ns: Optional[int] = None,
        script_args: Optional[dict] = None,
        exec_funcs=None,
    ) -> QueryResult:
        qid = query_id or str(uuid.uuid4())
        # Local root span (r11): a standalone engine produces the same
        # trace shape the broker path does, rooted at the query_id. When
        # an ambient context exists (an agent executing a broker plan
        # calls execute_plan directly), this path is not taken.
        root = trace.begin(
            "query", trace_id=qid, parent_id="", instance=self.instance
        )
        t0 = time.perf_counter_ns()
        # r15: a standalone engine attributes its own CPU/device work to
        # the query (the broker/agent paths set their own attribution).
        with trace.attribution(qid, "default", "query"):
            with trace.context_of(root):
                with trace.span("compile", instance=self.instance):
                    plan = self.compiler.compile(
                        query,
                        self.table_store.relation_map(),
                        now_ns=now_ns,
                        script_args=script_args,
                        query_id=qid,
                        exec_funcs=exec_funcs,
                    )
                compile_ns = time.perf_counter_ns() - t0
                result = self.execute_plan(plan, analyze=analyze)
        result.compile_time_ns = compile_ns
        if root is not None:
            trace.finish(root)
            result.trace_spans = sorted(
                (s.to_dict() for s in trace.spans_for(qid)),
                key=lambda s: s["start_unix_ns"],
            )
        return result

    def execute_plan(
        self,
        plan: Plan,
        analyze: bool = False,
        manage_router: bool = True,
        deadline_s: Optional[float] = None,
        bridge_token: Optional[tuple] = None,
    ) -> QueryResult:
        """manage_router=False when a broker coordinates several engine
        instances over one shared router: producer registration and query
        cleanup then happen centrally (ref: the GRPCRouter is owned by the
        receiving agent, registration by connection).

        ``deadline_s`` is the propagated per-query hard deadline (r9): all
        fragments share one absolute deadline computed here, so a stalled
        fragment raises QueryDeadlineExceeded instead of holding the agent
        thread to the stall timeout."""
        qid = plan.query_id or str(uuid.uuid4())
        deadline = (
            time.monotonic() + deadline_s
            if deadline_s is not None and deadline_s > 0
            else None
        )
        tables: dict[str, list[RowBatch]] = {}

        def on_result(table_name: str, batch: RowBatch) -> None:
            tables.setdefault(table_name, []).append(batch)

        # Register bridge producers so consumers know their eos counts.
        if manage_router:
            for frag in plan.fragments:
                for nid in frag.nodes():
                    op = frag.node(nid)
                    if isinstance(op, BridgeSinkOp):
                        self.router.register_producer(qid, op.bridge_id)

        exec_stats: dict[str, dict] = {}
        my_states: list = []
        t0 = time.perf_counter_ns()
        try:
            # Producer fragments run before consumers (the reference runs
            # them concurrently across agents; one engine instance runs its
            # own fragments in dependency order — bridge queues buffer).
            ambient = trace.current()
            for frag in plan.fragment_topo_order():
                if self.attempt_cancelled(qid, bridge_token):
                    # r17: the broker cancelled this attempt between
                    # fragments (another attempt won) — stop here; the
                    # caller withholds whatever was produced.
                    break
                fspan = trace.span(
                    "fragment",
                    # Without an ambient context (bare execute_plan), the
                    # fragment spans still join the query's trace: the
                    # query_id is the trace_id.
                    trace_id=None if ambient else qid,
                    instance=self.instance,
                    attrs={"fragment_id": frag.fragment_id},
                )
                with fspan:
                    state = ExecState(
                        qid,
                        self.table_store,
                        self.registry,
                        router=self.router,
                        metadata_state=self.metadata_state,
                        result_callback=on_result,
                        instance=self.instance,
                        vizier_ctx=self.vizier_ctx,
                        otel_exporter=self.otel_exporter,
                        deadline=deadline,
                        bridge_token=bridge_token,
                        device=(
                            self.device_executor.device
                            if self.device_executor is not None
                            else self.device
                        ),
                    )
                    my_states.append(state)
                    self._track_state(qid, state)
                    if self.device_executor is not None:
                        offloaded = self.device_executor.try_execute_fragment(
                            frag, self.table_store, self.registry,
                            state.func_ctx,
                        )
                        if offloaded is not None:
                            agg_nid, batch = offloaded
                            key = f"device:{frag.fragment_id}:{agg_nid}"
                            # A windowed aggregation returns one batch a
                            # window (eow-cadenced, as the host AggNode).
                            batches = batch if isinstance(batch, list) else [batch]
                            state.inline_batches[key] = batches
                            # A StateBatch (a PARTIAL aggregation) has no
                            # relation: the aggregation's declared output.
                            rel = getattr(batches[0], "relation", None)
                            if rel is None:
                                rel = frag.resolve_relations(
                                    self.registry,
                                    lambda op: self.table_store.get_relation(op.table_name),
                                )[agg_nid]
                            frag = _splice_inline_source(frag, agg_nid, key, rel)
                    graph = ExecutionGraph(frag, state)
                    graph.execute()
                    if analyze:
                        for name, s in graph.stats().items():
                            exec_stats[f"f{frag.fragment_id}/{name}"] = s
        finally:
            self._untrack_states(qid, my_states)
            if manage_router:
                self.router.cleanup_query(qid)
        exec_ns = time.perf_counter_ns() - t0
        return QueryResult(
            query_id=qid,
            tables=tables,
            exec_stats=exec_stats,
            exec_time_ns=exec_ns,
        )
