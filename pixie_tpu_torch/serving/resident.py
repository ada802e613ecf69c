"""Device-resident incremental ingest: device ring tables fed by appends.

A copy of pixie_tpu/serving/resident.py for the port (the port imports
nothing of the reference). Telemetry is continuous and queries repeat, so a
hot table should not cold-stage its recent span: the ingest path pays the
copy incrementally, off any query's critical path, and a query finds the
table's full windows already on the card, staging only the tail.

- A ``ResidentRing`` listens to a Table's appends. Appends buffer on the
  host until a full ring window (``resident_window_rows`` rows, geometry
  from ``staging.block_geometry`` over the executor's mesh, exactly the
  stream plan's) is available; the window is then packed in RAW column
  dtypes, encoded with the staging codec where an encoder pays
  (``codec.plan_codec_local``, ``encode_window``), copied and decoded on
  the devices (H18, H19) into [D, nblk, b] blocks that stay resident: shard
  s of every window on the mesh's device s (one [D, nblk, b] tensor when
  every shard is on one device, a ``ShardedBlocks`` over distinct cards),
  as the reference shards its windows over its mesh. A column the codec
  declines is copied raw.
- Queries over the table stream at the ring's window size, so plan window w
  covers the same rows as ring window ``(min_row + w * W) / W``. On a hit
  the executor skips the pack and the copy and converts the raw blocks to
  the plan's dtypes on the card (``codec.convert_block``, H24: one launch a
  device over its shards): bit for bit the host pack, no wire bytes. Misses
  (the partial tail) stage as usual.
- Ring windows are registered with the ResidencyPool as permanently pinned
  bytes (``register_resident``: every shard's); the ring's depth bound
  (``resident_max_windows``) rolls the oldest window out and frees its
  accounting.

Staging runs on the writer's thread, inside ``Table.write``; each window's
device writes are complete (the stream of every device it lands on
synchronized) before the window is published, so any stream may read it.
The table catches and logs a failing append listener, so a staging failure
also invalidates the ring and is kept as ``last_error`` in ``snapshot()``.

The ring only serves FULL windows whose rows it observed gap-free in row-id
order: a skipped row id or a dtype mismatch invalidates it for good and
releases its windows' accounting; queries then stage from the host.

Not ported yet: the durable spill (flags ``durable_resident`` and
``wal_dir``; it needs vizier/durability's RingSpill) and the replica rings
(flag ``ring_replication_factor`` > 1; they need the broker plane). Creating
a ring with either flag set raises NotImplementedError.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.utils import flags, metrics_registry

_M = metrics_registry()
_WINDOWS = _M.counter(
    "resident_ingest_windows_total",
    "Ring windows staged to the device by the resident-ingest path.",
)
_WIRE = _M.counter(
    "resident_ingest_wire_bytes_total",
    "Bytes the resident-ingest path copied to the device (encoded).",
)
_HITS = _M.counter(
    "resident_window_hits_total",
    "Query stream windows served from device-resident ring windows "
    "(pack and copy skipped).",
)
_INVALID = _M.counter(
    "resident_ring_invalidated_total",
    "Rings permanently invalidated (row-id gap, column mismatch or a "
    "failed window staging).",
)

# Raw host dtypes the ring can hold, per column DataType (strings ride as
# their table-dictionary int32 codes, as read_columns returns them).
_RAW_DTYPES = {
    DataType.BOOLEAN: np.dtype(np.bool_),
    DataType.INT64: np.dtype(np.int64),
    DataType.FLOAT64: np.dtype(np.float64),
    DataType.STRING: np.dtype(np.int32),
    DataType.TIME64NS: np.dtype(np.int64),
}


def _check_ported_flags() -> None:
    if flags.durable_resident and flags.wal_dir:
        raise NotImplementedError(
            "durable_resident: the resident ring's durable spill "
            "(vizier/durability RingSpill) is not ported yet"
        )
    if int(flags.ring_replication_factor) > 1:
        raise NotImplementedError(
            "ring_replication_factor > 1: replica rings and ring replication "
            "are not ported yet"
        )


class ResidentWindow:
    __slots__ = ("index", "start_row", "rows", "blocks", "nbytes")

    def __init__(self, index, start_row, rows, blocks, nbytes):
        self.index = index
        self.start_row = start_row
        self.rows = rows
        self.blocks = blocks  # col -> [D, nblk, b] raw-dtype lane over the mesh's devices
        self.nbytes = nbytes


class ResidentRing:
    """Per-table device ring of full append windows in raw column dtypes."""

    def __init__(self, mesh, table, block_rows: int, pool=None):
        from pixie_tpu_torch.parallel.staging import block_geometry

        _check_ported_flags()
        self.mesh = mesh
        self.devices = mesh.devices  # shard s on devices[s]
        self.table_name = table.name
        self.window_rows = int(flags.resident_window_rows)
        self.d = len(self.devices)
        self.b, self.nblk = block_geometry(self.window_rows, self.d, block_rows)
        self._pool = pool
        self._lock = threading.Lock()
        self.columns: dict[str, np.dtype] = {}
        for c in table.relation:
            dt = _RAW_DTYPES.get(c.data_type)
            if dt is not None:
                self.columns[c.name] = dt
        self.windows: dict[int, ResidentWindow] = {}
        self._valid = bool(self.columns)
        self.last_error: Optional[str] = None
        # Buffered host rows cover [_buf_start, _next_row).
        self._next_row = table.end_row_id()
        self._buf_start = self._next_row
        self._buf: dict[str, list] = {n: [] for n in self.columns}

    # -- write side (table append listener) ----------------------------------
    def on_append(self, first_row_id: int, batch) -> None:
        from pixie_tpu_torch.table.column import DictColumn

        with self._lock:
            if not self._valid:
                return
            if first_row_id != self._next_row:
                self._invalidate_locked()
                return
            if batch.num_rows == 0:
                return
            chunk = {}
            for name, dt in self.columns.items():
                c = batch.col(name)
                arr = c.codes if isinstance(c, DictColumn) else np.asarray(c)
                if arr.dtype != dt:
                    # A batch whose host dtype differs from what read_columns
                    # returns must never be served.
                    self._invalidate_locked()
                    return
                chunk[name] = arr
            for name, arr in chunk.items():
                self._buf[name].append(arr)
            self._next_row += batch.num_rows
            try:
                self._stage_complete_windows_locked()
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
                self._invalidate_locked()
                raise

    def _invalidate_locked(self) -> None:
        self._valid = False
        _INVALID.inc()
        for w in list(self.windows):
            self._release_locked(w)
        self._buf = {n: [] for n in self.columns}

    def _stage_complete_windows_locked(self) -> None:
        W = self.window_rows
        while True:
            k = -(-self._buf_start // W)  # first window at/after the buffer
            if (k + 1) * W > self._next_row:
                return
            # Compact the buffer to single chunks once per staging.
            for name in self.columns:
                if len(self._buf[name]) > 1:
                    self._buf[name] = [np.concatenate(self._buf[name])]
            lo = k * W - self._buf_start
            self._stage_window_locked(
                k, {name: self._buf[name][0][lo : lo + W] for name in self.columns}
            )
            # Drop everything through the staged window.
            keep_from = (k + 1) * W - self._buf_start
            for name in self.columns:
                self._buf[name] = [self._buf[name][0][keep_from:]]
            self._buf_start = (k + 1) * W

    def _stage_window_locked(self, k: int, win_cols: dict) -> None:
        """Pack window ``k`` in raw dtypes, copy it (encoded where the codec
        pays) and decode it into resident [D, nblk, b] lanes, shard s on the
        mesh's device s; publish it once every device's writes are
        complete."""
        from pixie_tpu_torch.ops import codec
        from pixie_tpu_torch.parallel.staging import alloc_lane, codec_min_ratio, split_targets

        total = self.d * self.nblk * self.b
        W = self.window_rows
        min_ratio = codec_min_ratio()
        blocks = {}
        nbytes = 0
        wire = 0
        for name, a in win_cols.items():
            flat = np.zeros(total, dtype=a.dtype)
            flat[:W] = a
            payload = None
            if flags.staging_codec:
                cp = codec.plan_codec_local(flat, self.d, self.nblk, self.b, W, min_ratio)
                if cp is not None:
                    try:
                        payload = codec.encode_window(flat, cp, W)
                    except codec.CodecOverflow:
                        payload = None
            out = alloc_lane((self.d, self.nblk, self.b), codec.TORCH_DTYPES[flat.dtype],
                             self.devices)
            # One decode or copy a device: the whole [D, shard_len] block on
            # a one-device mesh, a shard a card over distinct cards.
            for part, dst in split_targets(payload if payload is not None else flat, out):
                if isinstance(part, codec.CodecPayload):
                    args = [torch.from_numpy(x).to(dst.device) for x in part.arrays]
                    codec.decode(args, part.plan, dst.view(part.plan.d, part.plan.shard_len))
                else:
                    dst.copy_(torch.from_numpy(part).reshape(dst.shape))
            wire += payload.nbytes if payload is not None else flat.nbytes
            blocks[name] = out
            nbytes += flat.nbytes
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                # Readers run on other threads' streams: the window is
                # published only after every device's copies and decodes
                # have finished.
                torch.cuda.current_stream(dev).synchronize()
        self.windows[k] = ResidentWindow(k, k * W, W, blocks, nbytes)
        _WINDOWS.inc()
        _WIRE.inc(wire)
        if self._pool is not None:
            self._pool.register_resident(("resident", self.table_name, k), nbytes)
        # Ring depth bound: roll the oldest window out.
        cap = max(int(flags.resident_max_windows), 1)
        while len(self.windows) > cap:
            self._release_locked(min(self.windows))

    def _release_locked(self, k: int) -> None:
        self.windows.pop(k, None)
        if self._pool is not None:
            self._pool.release_resident(("resident", self.table_name, k))

    # -- read side (query staging) -------------------------------------------
    def lookup(self, start_row: int, rows: int, needed_cols) -> Optional[ResidentWindow]:
        """The resident window covering EXACTLY rows [start_row, start_row +
        rows) with every needed column, or None. Only full, aligned windows
        match."""
        W = self.window_rows
        if rows != W or start_row % W != 0:
            return None
        with self._lock:
            if not self._valid:
                return None
            win = self.windows.get(start_row // W)
        if win is None:
            return None
        for name in needed_cols:
            if name not in win.blocks:
                return None
        _HITS.inc()
        return win

    def release_all(self) -> None:
        with self._lock:
            for k in list(self.windows):
                self._release_locked(k)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "table": self.table_name,
                "window_rows": self.window_rows,
                "windows": len(self.windows),
                "resident_rows": len(self.windows) * self.window_rows,
                "bytes": sum(w.nbytes for w in self.windows.values()),
                "valid": self._valid,
                "buffered_rows": self._next_row - self._buf_start,
                "last_error": self.last_error,
            }


class ResidentIngestManager:
    """The DeviceExecutor's registry of per-table rings, each sharded over
    ``mesh`` (the executor's full geometry)."""

    def __init__(self, mesh, block_rows: int, pool=None):
        self.mesh = mesh
        self.block_rows = block_rows
        self.pool = pool
        self._lock = threading.Lock()
        self._rings: dict[str, ResidentRing] = {}

    def enable(self, table) -> Optional[ResidentRing]:
        """Attach a ring to ``table`` (idempotent per table name). Returns
        the ring, or None when the table has no ring-able columns."""
        with self._lock:
            ring = self._rings.get(table.name)
            if ring is not None:
                return ring
            ring = ResidentRing(self.mesh, table, self.block_rows, self.pool)
            if not ring.columns:
                return None
            self._rings[table.name] = ring
        table.add_append_listener(ring.on_append)
        return ring

    def ring_for(self, table_name: str) -> Optional[ResidentRing]:
        with self._lock:
            return self._rings.get(table_name)

    def snapshot(self) -> dict:
        with self._lock:
            rings = list(self._rings.values())
        return {r.table_name: r.snapshot() for r in rings}
