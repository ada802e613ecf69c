"""Device table residency: the staged-table cache as a managed pool.

A copy of pixie_tpu/serving/residency.py for the port (the port imports
nothing of the reference). The DeviceExecutor's staged cache holds the
[1, nblk, B] blocks a table version is staged into once and served to
every matching query; device memory is what a serving process shares, so
the cache is accounted in BYTES:

- **Per-entry byte accounting.** An entry's cost is the bytes of its
  device blocks (columns + mask + gids), computed once at insert
  (``staged_nbytes``). Live totals ride the metrics registry as
  ``device_staged_bytes`` / ``device_staged_pinned_bytes``.
- **Query-scoped pinning.** A fold in flight pins its entry
  (``with pool.pin(key): ...``); pinned entries are never evicted, not by
  the byte watermark, not by version supersession, not by a clear. A
  superseded-but-pinned entry leaves the key table at once (lookups miss)
  but its bytes stay accounted as a zombie until the last unpin reaps it.
  Eviction passes that skip a pinned entry check the
  ``serving.evict_pinned_attempt`` fault site.
- **LRU eviction with high/low watermarks.** With ``hbm_budget_mb`` set,
  an insert that pushes the pool past the high watermark (95% of the
  budget) evicts least-recently-used unpinned entries until under the low
  watermark (80%). The entry-count cap still applies as a second bound;
  with no budget (the default) it is the only one.
- **Resident ring windows** (serving/resident.py) register their bytes as
  used and pinned (``register_resident``); only the ring releases them.

The reference's HBM usage sampling (``sample_usage``, rows for its
profiler's hbm_usage table) waits for that profiler's port: here it
returns at once.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional

from pixie_tpu_torch.utils import faults, flags, metrics_registry

_M = metrics_registry()
_STAGED_BYTES = _M.gauge(
    "device_staged_bytes",
    "Bytes of device-resident staged table blocks in the residency pool "
    "(including superseded entries still pinned by in-flight folds).",
)
_PINNED_BYTES = _M.gauge(
    "device_staged_pinned_bytes",
    "Bytes of staged blocks pinned by in-flight folds (never evictable).",
)
_ENTRIES = _M.gauge(
    "device_staged_entries", "Entries in the staged-table residency pool."
)
_EVICTIONS = _M.counter(
    "device_staged_cache_evictions_total",
    "Staged-table cache evictions (LRU cap, byte watermark, version "
    "change, clear, or a resident window rolled out).",
)
_PIN_SKIPS = _M.counter(
    "device_staged_evict_pinned_skips_total",
    "Eviction passes that skipped an entry because an in-flight fold "
    "had it pinned.",
)

HIGH_WATERMARK = 0.95
LOW_WATERMARK = 0.80


def _tensor_nbytes(t: Any) -> int:
    numel = getattr(t, "numel", None)
    if numel is None:
        return 0
    return int(numel()) * int(t.element_size())


def _lane_nbytes(lane: Any) -> int:
    """A staged lane's bytes: a tensor's, or the sum over the shards of a
    lane sharded over distinct devices (``parts``)."""
    parts = getattr(lane, "parts", None)
    if parts is not None:
        return sum(_tensor_nbytes(p) for p in parts)
    return _tensor_nbytes(lane)


def staged_nbytes(staged: Any) -> int:
    """Device bytes of a StagedColumns entry: column blocks + validity mask
    + (optional) gid blocks, ``numel() * element_size()`` of each tensor,
    summed over the shards of a mesh (one budget, ``hbm_budget_mb``, for
    them all, as the reference reads a sharded array's global ``nbytes``).
    Anything without those attributes (test shims) counts 0."""
    total = 0
    for t in getattr(staged, "blocks", {}).values():
        total += _lane_nbytes(t)
    total += _lane_nbytes(getattr(staged, "mask", None))
    total += _lane_nbytes(getattr(staged, "gids", None))
    return total


class _Entry:
    __slots__ = ("staged", "nbytes", "table_name", "version", "pins", "dead")

    def __init__(self, staged, nbytes, table_name, version):
        self.staged = staged
        self.nbytes = nbytes
        self.table_name = table_name
        self.version = version
        self.pins = 0
        self.dead = False  # superseded while pinned: reap at last unpin


class ResidencyPool:
    """The DeviceExecutor's staged-table cache, byte-accounted and pinnable.

    ``get``/``insert``/``items``/``touch``/``clear`` plus the ``pin``
    context manager; every method is thread-safe (concurrent queries and
    shared scans hit one pool)."""

    def __init__(
        self,
        cap_entries: Optional[int] = None,
        budget_bytes: Optional[int] = None,
    ):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Any, _Entry]" = collections.OrderedDict()
        # Superseded-while-pinned entries: out of the key table (lookups
        # must miss), bytes still resident until the last unpin.
        self._zombies: list[_Entry] = []
        self._cap_entries = cap_entries
        self._budget_bytes = budget_bytes
        self._used = 0
        self._pinned = 0
        # Resident ring windows: byte-accounted like staged entries and
        # permanently pinned (never evicted, never cleared); only the ring
        # releases them.
        self._resident: dict = {}

    # -- configuration (read per call so flag flips apply live) --------------
    def _cap(self) -> int:
        return self._cap_entries if self._cap_entries is not None else flags.staged_cache_cap

    def budget_bytes(self) -> int:
        if self._budget_bytes is not None:
            return self._budget_bytes
        return int(flags.hbm_budget_mb) * (1 << 20)

    # -- lookup --------------------------------------------------------------
    def get(self, key) -> Optional[Any]:
        """The staged entry for ``key`` (LRU-touched), or None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            return e.staged

    def touch(self, key) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    def items(self) -> list:
        """(key, staged) snapshot in LRU order (the superset-reuse walk)."""
        with self._lock:
            return [(k, e.staged) for k, e in self._entries.items()]

    def values(self) -> list:
        with self._lock:
            return [e.staged for e in self._entries.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- mutation ------------------------------------------------------------
    def insert(self, key, staged, table_name, version) -> None:
        """Register a staged entry: supersede stale versions of the same
        table, account bytes, then enforce the byte watermark and the entry
        cap (LRU, pinned entries skipped)."""
        nbytes = staged_nbytes(staged)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._retire_locked(old, reason="replaced")
            # A new version of a table supersedes every older staging of it.
            for k in [
                k for k, e in self._entries.items()
                if e.table_name == table_name and e.version != version
            ]:
                self._retire_locked(self._entries.pop(k), reason="version")
            self._entries[key] = _Entry(staged, nbytes, table_name, version)
            self._used += nbytes
            budget = self.budget_bytes()
            if budget > 0 and self._used > budget * HIGH_WATERMARK:
                self._evict_to_locked(int(budget * LOW_WATERMARK), protect=key)
            cap = self._cap()
            while len(self._entries) > cap:
                victim = self._lru_unpinned_locked(protect=key)
                if victim is None:
                    break  # everything pinned: over cap beats corruption
                self._retire_locked(self._entries.pop(victim), reason="lru")
            self._publish_locked()

    def clear(self, reason: str = "oom") -> None:
        """Drop every staged entry; the resident ring windows stay. Pinned
        entries' bytes stay accounted as zombies until their folds unpin."""
        with self._lock:
            for k in list(self._entries):
                self._retire_locked(self._entries.pop(k), reason=reason)
            self._publish_locked()

    # -- resident ring windows -----------------------------------------------
    def register_resident(self, key, nbytes: int) -> None:
        """Account a resident ring window's bytes as used AND pinned: no pool
        policy evicts it, the ring owns its lifetime."""
        with self._lock:
            old = self._resident.pop(key, None)
            if old is not None:
                self._used -= old
                self._pinned -= old
            self._resident[key] = int(nbytes)
            self._used += int(nbytes)
            self._pinned += int(nbytes)
            self._publish_locked()

    def release_resident(self, key) -> None:
        """Free a ring window's accounting (the ring rolled past it, or was
        invalidated or released)."""
        with self._lock:
            nbytes = self._resident.pop(key, None)
            if nbytes is not None:
                self._used -= nbytes
                self._pinned -= nbytes
                _EVICTIONS.inc(reason="resident_roll")
                self._publish_locked()

    # -- pinning -------------------------------------------------------------
    class _Pin:
        def __init__(self, pool: "ResidencyPool", key):
            self._pool = pool
            self._key = key
            self._entry: Optional[_Entry] = None

        def __enter__(self):
            self._entry = self._pool._pin(self._key)
            return self

        def __exit__(self, *exc):
            if self._entry is not None:
                self._pool._unpin(self._entry)
                self._entry = None
            return False

    def pin(self, key) -> "ResidencyPool._Pin":
        """Context manager: while held, the entry (if present at enter)
        cannot be evicted; a version bump or a clear retires it from the key
        table but its bytes stay accounted until exit. Pinning a missing key
        is a no-op."""
        return ResidencyPool._Pin(self, key)

    def _pin(self, key) -> Optional[_Entry]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.pins += 1
                self._pinned += e.nbytes
                self._publish_locked()
            return e

    def _unpin(self, e: _Entry) -> None:
        with self._lock:
            e.pins -= 1
            self._pinned -= e.nbytes
            if e.pins == 0 and e.dead:
                # Superseded or cleared while this fold ran: reap now.
                self._zombies.remove(e)
                self._used -= e.nbytes
                _EVICTIONS.inc(reason="deferred")
            self._publish_locked()

    # -- internals (call under self._lock) -----------------------------------
    def _lru_unpinned_locked(self, protect=None):
        for k, e in self._entries.items():
            if k == protect:
                continue
            if e.pins > 0:
                if faults.ACTIVE:
                    faults.fires("serving.evict_pinned_attempt")
                _PIN_SKIPS.inc()
                continue
            return k
        return None

    def _evict_to_locked(self, target_bytes: int, protect=None) -> None:
        while self._used > target_bytes:
            victim = self._lru_unpinned_locked(protect=protect)
            if victim is None:
                break  # only pinned entries left
            self._retire_locked(self._entries.pop(victim), reason="bytes")

    def _retire_locked(self, e: _Entry, reason: str) -> None:
        """Remove an entry already popped from the key table: free its
        accounting at once when unpinned, else zombie it until the last
        unpin."""
        if e.pins > 0:
            if faults.ACTIVE:
                faults.fires("serving.evict_pinned_attempt")
            _PIN_SKIPS.inc()
            e.dead = True
            self._zombies.append(e)
            return
        self._used -= e.nbytes
        _EVICTIONS.inc(reason=reason)

    def _publish_locked(self) -> None:
        _STAGED_BYTES.set(self._used)
        _PINNED_BYTES.set(self._pinned)
        _ENTRIES.set(len(self._entries))

    def sample_usage(self, force: bool = True) -> None:
        """The reference's hbm_usage snapshot. It feeds the reference's
        profiler (pixie_tpu/parallel/profiler.py), which is not ported yet,
        so there is nothing to sample into: returns at once."""
        return None

    # -- observability -------------------------------------------------------
    def snapshot(self) -> dict:
        """Residency state (entries, bytes used and pinned, zombies, ring
        windows, the budget and its headroom, the tables staged)."""
        with self._lock:
            budget = self.budget_bytes()
            return {
                "entries": len(self._entries),
                "used_bytes": self._used,
                "pinned_bytes": self._pinned,
                "zombie_entries": len(self._zombies),
                "resident_windows": len(self._resident),
                "resident_bytes": sum(self._resident.values()),
                "budget_bytes": budget,
                "headroom_bytes": max(budget - self._used, 0) if budget > 0 else None,
                "tables": sorted({e.table_name for e in self._entries.values()}),
            }

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned
