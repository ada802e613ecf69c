"""Host -> device staging: table columns -> padded blocks on one CUDA device.

Counterpart of pixie_tpu/parallel/staging.py for one device: columns are
read through a table cursor, int columns whose value range fits are narrowed
to uint8/uint16/int32 of (value - offset) (frame of reference, widened back
to int64 per block on the device), float64 columns read only by f32-grained
sketches stage as float32, and everything is padded to [1, nblk, B] blocks
with a validity mask built on the device (row index < num_rows). Group ids
densified on the host (multi-column and non-dictionary keys) stage as one
more per-block lane, narrowed to uint8/uint16 when the group count fits. The
block geometry is the reference's, so both packages cut a table into the
same blocks.

This slice stages uncompressed and in one piece: the reference's staging
codec (ops/codec.py) and its streamed, double-buffered cold path are not
ported yet. Strings never leave the host: their int32 dictionary codes do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.table.table import Table
from pixie_tpu_torch.utils import flags, trace

DEFAULT_BLOCK_ROWS = 1 << 17

# Cold-path phase timings (cumulative seconds since the last reset), as in
# the reference: host column reads, host pack, host -> device transfer.
COLD_PROFILE: dict[str, float] = {}


def reset_cold_profile() -> dict:
    snap = dict(COLD_PROFILE)
    COLD_PROFILE.clear()
    return snap


class timed:
    """with timed('stage'): ... — accumulates into COLD_PROFILE and emits a
    ``device.<key>`` trace span under the running query's context."""

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        COLD_PROFILE[self.key] = COLD_PROFILE.get(self.key, 0.0) + dt
        if trace.ACTIVE:
            trace.phase(f"device.{self.key}", dt)
        return False


@dataclasses.dataclass
class StagedColumns:
    """Columns resident on the device."""

    blocks: dict[str, torch.Tensor]  # name -> [1, nblk, B]
    mask: torch.Tensor  # [1, nblk, B] bool, False on padding
    num_rows: int
    block_rows: int
    # name -> offset of the frame-of-reference narrowed int columns.
    narrow_offsets: dict = dataclasses.field(default_factory=dict)
    # [1, nblk, B] host-densified group ids (uint8/uint16/int32), or None.
    gids: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.mask.shape[1]


def _pow2_at_least(n: int, floor: int = 8) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


def bucket_block_count(n: int) -> int:
    """Round a block count up to its quarter-octave bucket
    ({1..8, 10, 12, 14, 16, 20, 24, ...}): <= 25% padding, O(log) shapes."""
    if n <= 8:
        return max(n, 1)
    step = 1 << ((n - 1).bit_length() - 3)
    return ((n + step - 1) // step) * step


def block_geometry(num_rows: int, d: int, block_rows: int) -> tuple[int, int]:
    """(block size b, blocks per device nblk) for ``num_rows`` over ``d``
    devices — the reference's geometry, bucketed under
    ``signature_buckets``."""
    if flags.signature_buckets:
        padded = _pow2_at_least(max(num_rows, 1), floor=1)
        b = min(block_rows, _pow2_at_least(max(padded // d, 1), floor=256))
        nblk = bucket_block_count(
            max((num_rows + d * b - 1) // (d * b), 1)
        )
    else:
        b = min(
            block_rows, _pow2_at_least(max(num_rows // d, 1), floor=256)
        )
        nblk = max((num_rows + d * b - 1) // (d * b), 1)
    return b, nblk


def read_columns(
    table: Table,
    columns: list[str],
    start_time: Optional[int] = None,
    stop_time: Optional[int] = None,
) -> tuple[dict[str, np.ndarray], int]:
    """Materialize the needed columns via a cursor (host side). String
    columns come back as their int32 code arrays."""
    batches = []
    cur = table.cursor(start_time, stop_time)
    while not cur.done():
        b = cur.next_batch()
        if b is None:
            break
        if b.num_rows:
            batches.append(b)
    cols: dict[str, np.ndarray] = {}
    for name in columns:
        parts = []
        for b in batches:
            c = b.col(name)
            parts.append(c.codes if isinstance(c, DictColumn) else np.asarray(c))
        cols[name] = np.concatenate(parts) if parts else np.empty(0, np.int32)
    return cols, sum(b.num_rows for b in batches)


def _narrow_int(arr: np.ndarray) -> tuple[np.ndarray, Optional[int]]:
    """Frame-of-reference narrowing of int64 values and int32 dictionary
    codes: (value - min) as uint8/uint16 (or int32 for int64 inputs) when
    the range fits; (arr, None) when it does not."""
    if arr.size == 0 or arr.dtype not in (np.int64, np.int32):
        return arr, None
    lo = int(arr.min())
    hi = int(arr.max())
    rng = hi - lo
    if rng <= 0xFF:
        return (arr - lo).astype(np.uint8), lo
    if rng <= 0xFFFF:
        return (arr - lo).astype(np.uint16), lo
    if arr.dtype == np.int64 and rng < (1 << 31):
        return (arr - lo).astype(np.int32), lo
    return arr, None


def _narrow_gids(gids: np.ndarray, num_groups: int) -> np.ndarray:
    """Dense gids ship as uint8/uint16 when the group count fits; the fold
    widens them to int32 per block."""
    if num_groups <= 0xFF + 1:
        return gids.astype(np.uint8)
    if num_groups <= 0xFFFF + 1:
        return gids.astype(np.uint16)
    return gids.astype(np.int32)


def build_mask(nblk: int, b: int, num_rows: int, device) -> torch.Tensor:
    """Validity mask [1, nblk, b] computed on the device (iota < num_rows),
    so no mask bytes cross the host link."""
    return (torch.arange(nblk * b, device=device) < num_rows).reshape(1, nblk, b)


def stage_columns(
    cols: dict[str, np.ndarray],
    num_rows: int,
    device,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    f32_cols: Optional[set] = None,
    gids: Optional[np.ndarray] = None,
    num_groups: int = 0,
) -> StagedColumns:
    """Pad/reshape host columns (and host-densified ``gids`` of
    ``num_groups`` groups, when given) into [1, nblk, B] blocks on
    ``device``."""
    b, nblk = block_geometry(num_rows, 1, block_rows)
    total = nblk * b

    def put(a: np.ndarray) -> torch.Tensor:
        with timed("stage_host_pack"):
            flat = np.zeros(total, dtype=a.dtype if a.size else np.int32)
            flat[:num_rows] = a
        with timed("stage_transfer"):
            out = torch.from_numpy(flat).to(device).reshape(1, nblk, b)
        COLD_PROFILE["stage_bytes"] = COLD_PROFILE.get("stage_bytes", 0.0) + float(
            flat.nbytes
        )
        return out

    narrow_offsets: dict[str, int] = {}
    blocks: dict[str, torch.Tensor] = {}
    for name, a in cols.items():
        with timed("stage_host_pack"):
            if f32_cols and name in f32_cols and a.dtype == np.float64:
                a = a.astype(np.float32)
            else:
                a, off = _narrow_int(a)
                if off is not None:
                    narrow_offsets[name] = off
        blocks[name] = put(a)
    staged_gids = None
    if gids is not None:
        with timed("stage_host_pack"):
            narrow = _narrow_gids(gids, num_groups)
        staged_gids = put(narrow)
    return StagedColumns(
        blocks=blocks,
        mask=build_mask(nblk, b, num_rows, device),
        num_rows=num_rows,
        block_rows=b,
        narrow_offsets=narrow_offsets,
        gids=staged_gids,
    )
