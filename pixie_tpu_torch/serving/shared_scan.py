"""Shared scans: concurrent compatible queries share one fold dispatch.

A copy of pixie_tpu/serving/shared_scan.py for the port (the port imports
nothing of the reference). Shared-scan engines (Crescando, SharedDB) batch
concurrent queries over the same hot table into one scan whose per-query
predicates evaluate inline. Here the unit of sharing is the device fold
of ``DeviceExecutor`` (parallel/pipeline.py), on a two-rung ladder:

1. **Identical signature**: the first arrival (the leader) dispatches;
   queries whose EXACT key matches (the staged entry's identity, the H17
   program with its predicates, the UDA lanes, the key mode, capacity and
   passes, the agg stage, a digest of the aux values) attach while the
   dispatch is in flight (plus the optional pre-dispatch window,
   ``shared_scan_window_ms``) and reuse the leader's outputs. Output names
   and finalize modes are not in the key: finalize fans out per query.
2. **Predicate-compatible** (flag ``shared_scan_predicate_batching``):
   queries that match on everything EXCEPT their predicates, and whose
   predicates normalize to data terms (pipeline.normalize_predicates),
   assemble into one BATCHED dispatch: the leader's
   ``compute_batch(slot_terms)`` runs one scan of the staged blocks with
   one masked state lane per distinct predicate set (K16: the slot masks
   by H22, the sum family by H23), and every participant receives its own
   slot's outputs.

Both rungs give what serial execution gives: followers consume the
arrays a serial run of their query would have produced (bit for bit on
the CPU; on the card within the f64 sums' order bound, PERF.md).

The batching window is demand-gated: a leader only sleeps
``shared_scan_window_ms`` when a registered queue-depth function
(``set_queue_depth_fn``) reports waiting work; with none registered the
leader always sleeps the window, so a standalone engine batches
deterministically under a window.

Observability: each participating query records a ``serving.shared_scan``
trace span carrying ``shared_scan_batch_size`` and its role, and the
metrics registry counts dispatches against saved dispatches, the
per-dispatch batch size and BATCH WIDTH histograms (distinct predicate
slots served by one scan), and followers that detached.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from pixie_tpu_torch.utils import flags, metrics_registry, trace

_M = metrics_registry()
_DISPATCHES = _M.counter(
    "serving_shared_scan_dispatches_total",
    "Device fold dispatches issued through the shared-scan coordinator.",
)
_SAVED = _M.counter(
    "serving_shared_scan_saved_dispatches_total",
    "Device fold dispatches avoided by joining another query's in-flight "
    "(or batching-window) shared scan.",
)
_BATCH_SIZE = _M.histogram(
    "serving_shared_scan_batch_size",
    "Queries served per shared-scan dispatch.",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64),
)
_BATCH_WIDTH = _M.histogram(
    "serving_shared_scan_batch_width",
    "Distinct predicate slots served per shared-scan dispatch (>1 "
    "means predicate-compatible queries shared one batched scan).",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64),
)
_PRED_BATCHED = _M.counter(
    "serving_shared_scan_predicate_batched_queries_total",
    "Queries served from a predicate-batched (width > 1) dispatch.",
)
_WINDOW_SKIPS = _M.counter(
    "serving_shared_scan_window_skips_total",
    "Batching windows skipped because the queue-depth function reported "
    "no waiting work (a solo query pays no window).",
)
_DETACHED = _M.counter(
    "serving_shared_scan_follower_detach_total",
    "Followers that detached from a batch whose leader died mid-"
    "dispatch and completed SOLO: the leader's failure is not "
    "contagious — each follower re-runs its own compute, bit-identical "
    "to never having joined.",
)

# Admission-queue depth gate for the batching window. None = unknown
# (no queue-depth function registered): always sleep the window
# so standalone engines batch deterministically under a window.
_QUEUE_DEPTH_FN: Optional[Callable[[], int]] = None


def set_queue_depth_fn(fn: Optional[Callable[[], int]]) -> None:
    global _QUEUE_DEPTH_FN
    _QUEUE_DEPTH_FN = fn


def clear_queue_depth_fn(fn: Optional[Callable[[], int]] = None) -> None:
    """Unset the gate — only if ``fn`` still owns it (a stopped owner
    must not yank a newer owner's wiring)."""
    global _QUEUE_DEPTH_FN
    if fn is None or _QUEUE_DEPTH_FN is fn:
        _QUEUE_DEPTH_FN = None


def _queue_depth() -> int:
    """Live queue depth, or -1 when unknown."""
    fn = _QUEUE_DEPTH_FN
    if fn is None:
        return -1
    try:
        return int(fn())
    except Exception:
        return -1


def aux_digest(aux_vals) -> str:
    """Content digest of the replicated aux arguments (key LUTs,
    int-dict LUTs, constants): aux SHAPES are in the fold signature but
    two queries with equal shapes and different values must not share a
    dispatch."""
    h = hashlib.sha1()
    for v in aux_vals:
        a = np.asarray(v)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class _Batch:
    """One in-flight dispatch: a list of slots (distinct exact keys,
    each with its normalized predicate terms) plus everyone waiting on
    the published per-slot results."""

    __slots__ = (
        "event", "results", "error", "slots", "terms", "joiners",
        "closed", "published", "batch_key",
    )

    def __init__(self, batch_key=None):
        self.event = threading.Event()
        self.results: "list | None" = None
        self.error: "BaseException | None" = None
        self.slots: dict[Any, int] = {}  # exact key -> slot index
        self.terms: list = []  # per-slot predicate terms (None = opaque)
        self.joiners = 0
        self.closed = False  # slot set frozen: the leader is dispatching
        self.published = False  # results visible; late arrivals start fresh
        self.batch_key = batch_key


class SharedScanCoordinator:
    """Coalesces compatible compute() calls into shared executions.

    ``run(key, compute)`` — the first caller for a key becomes the
    leader: it (optionally) waits the batching window, executes,
    publishes, and wakes the batch. Callers arriving before publication
    join and return the leader's result without dispatching. With the
    second rung (``batch_key``/``terms``/``compute_batch``), callers
    whose exact keys differ but whose batch keys match join the same
    dispatch as separate SLOTS — the leader then runs ONE
    ``compute_batch(slot_terms)`` returning a result per slot. A leader
    error makes every follower DETACH and complete solo (a killed
    leader must not take its batch down with it); a failure the
    follower would hit too re-raises from its solo run."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_exact: dict[Any, _Batch] = {}
        self._by_batch: dict[Any, _Batch] = {}

    def run(
        self,
        key,
        compute: Callable[[], Any],
        batch_key=None,
        terms=None,
        compute_batch: Optional[Callable[[list], list]] = None,
    ):
        batchable = (
            batch_key is not None
            and terms is not None
            and compute_batch is not None
        )
        max_width = max(int(flags.shared_scan_max_batch), 1)
        with self._lock:
            b = self._by_exact.get(key)
            if b is not None and not b.published:
                # Rung 1: identical signature — share the slot (works
                # even after close: the slot's result is determined).
                b.joiners += 1
                slot = b.slots[key]
                leader = False
            else:
                g = self._by_batch.get(batch_key) if batchable else None
                if (
                    g is not None
                    and not g.closed
                    and not g.published
                    and len(g.terms) < max_width
                ):
                    # Rung 2: predicate-compatible — a new slot in an
                    # open batch.
                    slot = len(g.terms)
                    g.slots[key] = slot
                    g.terms.append(terms)
                    g.joiners += 1
                    self._by_exact[key] = g
                    b = g
                    leader = False
                else:
                    b = _Batch(batch_key if batchable else None)
                    b.joiners = 1
                    b.slots[key] = 0
                    b.terms.append(terms)
                    slot = 0
                    self._by_exact[key] = b
                    if batchable:
                        self._by_batch[batch_key] = b
                    leader = True
        if not leader:
            b.event.wait()
            _SAVED.inc()
            with self._lock:
                size = b.joiners
                width = len(b.terms)
            if width > 1:
                _PRED_BATCHED.inc()
            self._span(size, width, role="follower")
            if b.error is not None:
                # Leader died mid-batch: detach and complete SOLO
                # — the follower re-runs ITS OWN compute, bit-identical
                # to never having joined the batch. A failure that
                # would hit the follower too (a sick device) re-raises
                # from the solo run, to its caller.
                _DETACHED.inc()
                self._span(1, 1, role="detached")
                return compute()
            return b.results[slot]
        # Leader: batching window (demand-gated), then dispatch.
        window_s = float(flags.shared_scan_window_ms) / 1e3
        if window_s > 0:
            if _queue_depth() == 0:
                _WINDOW_SKIPS.inc()
            else:
                time.sleep(window_s)
        with self._lock:
            b.closed = True
            slot_terms = list(b.terms)
        try:
            if len(slot_terms) == 1:
                result_list = [compute()]
            else:
                result_list = compute_batch(slot_terms)
            err = None
        except BaseException as e:  # propagate to every joiner
            result_list, err = None, e
        with self._lock:
            b.results = result_list
            b.error = err
            b.published = True
            for k2 in b.slots:
                if self._by_exact.get(k2) is b:
                    del self._by_exact[k2]
            if b.batch_key is not None and (
                self._by_batch.get(b.batch_key) is b
            ):
                del self._by_batch[b.batch_key]
            size = b.joiners
            width = len(slot_terms)
        b.event.set()
        _DISPATCHES.inc()
        _BATCH_SIZE.observe(size)
        _BATCH_WIDTH.observe(width)
        if width > 1:
            _PRED_BATCHED.inc()
        self._span(size, width, role="leader")
        if err is not None:
            raise err
        return b.results[0]

    @staticmethod
    def _span(batch_size: int, width: int, role: str) -> None:
        if trace.ACTIVE:
            trace.record(
                "serving.shared_scan",
                0,
                attrs={
                    "shared_scan_batch_size": batch_size,
                    "shared_scan_batch_width": width,
                    "role": role,
                },
            )
