"""Per-query execution state & function context.

Ref: src/carnot/exec/exec_state.h — holds the table store, UDF registry,
function context (metadata state for md UDFs), and query-scoped control
(source aborts from limits, result destinations).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from pixie_tpu_torch.device import resolve_device
from pixie_tpu_torch.utils import trace


class QueryDeadlineExceeded(TimeoutError):
    """A query's propagated hard deadline expired (ref: the forwarder's
    per-query timeout/cancel, query_result_forwarder.go:571). Distinct
    from a source-stall TimeoutError so agents can annotate the failure
    kind for the broker's degraded result."""


@dataclasses.dataclass
class FunctionContext:
    """Passed to UDFs with ``needs_ctx`` (ref: udf.h FunctionContext) —
    carries the agent's metadata state for k8s entity lookups, plus the
    introspection surfaces UDTFs read (ref: vizier/funcs/md_udtfs serves
    GetAgentStatus/table info from the service context)."""

    metadata_state: Any = None
    table_store: Any = None
    registry: Any = None
    # Cluster view for agent-status UDTFs: an object exposing
    # ``agents() -> list[dict]`` (the broker's tracker) and/or
    # ``self_info: dict`` (this agent). None outside a vizier deployment.
    vizier_ctx: Any = None


class ExecState:
    def __init__(
        self,
        query_id: str,
        table_store,
        registry,
        router=None,
        metadata_state=None,
        result_callback: Optional[Callable] = None,
        instance: str = "local",
        vizier_ctx: Any = None,
        otel_exporter: Any = None,
        deadline: Optional[float] = None,
        bridge_token: Optional[tuple] = None,
        device=None,
    ):
        self.query_id = query_id
        self.table_store = table_store
        self.registry = registry
        self.router = router
        self.func_ctx = FunctionContext(
            metadata_state,
            table_store=table_store,
            registry=registry,
            vizier_ctx=vizier_ctx,
        )
        # result_callback(table_name, row_batch) receives ResultSink output
        # (ref: Carnot's result destination / TransferResultChunk stream).
        self.result_callback = result_callback
        # OTel payload consumer (ref: the OTLP gRPC stub in the reference's
        # otel_export_sink_node); None drops exports.
        self.otel_exporter = otel_exporter
        self.instance = instance
        # The exec graph is the host-side (PEM-role) engine and runs in
        # numpy, but for the AggNode's UDA states: they live on ``device``
        # (None: the CUDA card), resolved by compute_device() when an
        # AggNode prepares, so a fragment with no aggregation needs none.
        self.device = device
        # Batches substituted by another executor (device pipeline results),
        # keyed by InlineSourceOp.key.
        self.inline_batches: dict[str, list] = {}
        self._keep_running = True
        # Hard per-query deadline (time.monotonic() timestamp) propagated
        # from the broker (r9). None = no deadline; the stall timeout is
        # then the only guard.
        self.deadline = deadline
        # Set by cancel(): why this query was aborted (deadline, broker
        # cancellation, source stall) — surfaced in errors/annotations.
        self.cancel_reason: Optional[str] = None
        # Trace context (r11): captured at construction so nodes running
        # on other threads (and the exec graph's end-of-run per-node span
        # emission) can parent to the fragment span even off this thread.
        self.trace_ctx: Optional[tuple] = trace.current()
        # Fragment-failover attempt identity (r17): the broker-assigned
        # (slot, epoch) this execution runs as. BridgeSink pushes carry
        # it (held + committed atomically per attempt at the router) and
        # BridgeSource polls read through a per-attempt cursor so a
        # replacement consumer replays the committed stream. None = the
        # pre-r17 direct push/pop semantics.
        self.bridge_token = bridge_token

    def compute_device(self) -> torch.device:
        """The device of the host AggNode's states: ``device`` resolved
        (None is CUDA, raising NoCudaDeviceError without a card)."""
        return resolve_device(self.device)

    # -- limit/source abort (ref: exec_state keep-running + limit signal) ---
    def stop_sources(self) -> None:
        self._keep_running = False

    @property
    def keep_running(self) -> bool:
        return self._keep_running

    # -- cancellation + deadlines (r9) --------------------------------------
    def cancel(self, reason: str) -> None:
        """Abort the query: stop sources and record why. Sibling nodes in
        the graph observe keep_running; the graph's abort path also closes
        sinks and releases bridge consumers."""
        if self.cancel_reason is None:
            self.cancel_reason = reason
        self._keep_running = False

    def deadline_exceeded(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    def check_deadline(self) -> None:
        if self.deadline_exceeded():
            raise QueryDeadlineExceeded(
                f"query {self.query_id}: deadline exceeded"
                + (f" ({self.cancel_reason})" if self.cancel_reason else "")
            )
