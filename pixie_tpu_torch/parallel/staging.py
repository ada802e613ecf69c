"""Host -> device staging: table columns -> padded shard-major blocks.

Counterpart of pixie_tpu/parallel/staging.py: columns are read through a
table cursor, int columns whose value range fits are narrowed to
uint8/uint16/int32 of (value - offset) (frame of reference, widened back to
int64 per block on the device), float64 columns read only by f32-grained
sketches stage as float32, small-domain INT64 columns read only by
cell-capable sketches stage as uint8/uint16 codes of a value LUT (the
int-dictionary cell lane), and everything is padded to [D, nblk, B] blocks
with a validity mask built on the device. Group ids densified on the host
(multi-column and non-dictionary keys) stage as one more per-block lane,
narrowed to uint8/uint16 when the group count fits. The block geometry is
the reference's (``block_geometry``), so both packages cut a table into the
same shards and blocks.

D is the mesh's shard count (distributed/mesh.py): shard i holds rows
[i * nblk * B, (i + 1) * nblk * B) of the staging (of each window, in the
stream) and lives on the mesh's device i. When every shard is on one device
(one card, logical shards of it, or the CPU) a lane is one [D, nblk, B]
tensor; over distinct devices it is a ``ShardedBlocks`` of one [1, nblk, B]
tensor a shard. ``StagedColumns.shard(i)`` is shard i's one-shard view,
which is what the fold reads.

With ``staging_codec`` (on by default, as in the reference) a packed column
or gid lane ships encoded when RLE or delta pays (ops/codec.py) and is
decoded on each shard's device into the block the raw copy would have
landed (H18, H19). ``stage_columns`` stages a table in one piece; the
streamed cold path (``plan_stream``, ``pack_stream_window``,
``WindowStager``) packs window k+1 on a background thread into a pinned
buffer while window k copies on a side stream of every device and folds,
and lands every window in its slice of one preallocated staging, which
becomes the warm-cache entry. ``stage_partitioned`` stages the
partitioned join's sides, each host's shard in its own region of devices.
Strings never leave the host: their int32 dictionary
codes do.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from pixie_tpu_torch.distributed.mesh import indexed_device
from pixie_tpu_torch.ops import codec, segment
from pixie_tpu_torch.table.column import DictColumn
from pixie_tpu_torch.table.table import Table
from pixie_tpu_torch.utils import faults, flags, trace

DEFAULT_BLOCK_ROWS = 1 << 17

# Cold-path phase timings (cumulative seconds since the last reset), as in
# the reference: host column reads, host pack, encode, host -> device
# transfer, decode, the stream's pack wait and puts; and counters: staged
# (decoded) bytes, wire bytes, stream windows. Concurrent queries add to it
# from their own threads: every update goes through ``profile_add``.
COLD_PROFILE: dict[str, float] = {}
_PROFILE_LOCK = threading.Lock()


def codec_min_ratio() -> float:
    """The ``staging_codec_min_ratio`` flag. (The reference scales it by its
    learned cost model when that model is warm, pixie_tpu/parallel/
    staging.py:35-48; the port has no cost model yet.)"""
    return float(flags.staging_codec_min_ratio)


def profile_add(key: str, value: float) -> None:
    """COLD_PROFILE[key] += value, atomically."""
    with _PROFILE_LOCK:
        COLD_PROFILE[key] = COLD_PROFILE.get(key, 0.0) + float(value)


def reset_cold_profile() -> dict:
    with _PROFILE_LOCK:
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
        profile_add(self.key, dt)
        if trace.ACTIVE:
            trace.phase(f"device.{self.key}", dt)
        return False


class ShardedBlocks:
    """A staged [D, nblk, B] lane whose shard s is the [1, nblk, B] tensor
    ``parts[s]`` on the mesh's device s: the lanes of a mesh over distinct
    devices. ``lane[:, lo:hi]`` is the lane of those blocks of every shard."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def __getitem__(self, idx) -> "ShardedBlocks":
        if not (isinstance(idx, tuple) and len(idx) == 2 and idx[0] == slice(None)):
            raise IndexError("a sharded lane slices its blocks only: lane[:, lo:hi]")
        return ShardedBlocks(p[idx] for p in self.parts)


Lane = Union[torch.Tensor, ShardedBlocks]


def as_devices(device) -> tuple:
    """A device, or a sequence of them (a mesh's, one a shard), as a tuple
    of torch.devices (a CUDA device with its index, as its tensors name
    it)."""
    if isinstance(device, (str, torch.device)):
        return (indexed_device(device),)
    return tuple(indexed_device(d) for d in device)


def shard_of(lane: Lane, s: int) -> torch.Tensor:
    """Shard ``s`` of a lane: a [1, nblk, B] tensor on its device."""
    if isinstance(lane, ShardedBlocks):
        return lane.parts[s]
    return lane[s : s + 1]


def lane_from_parts(parts: list, devices: tuple) -> Lane:
    """One lane from shard s's [1, ...] tensor on ``devices[s]``: one tensor
    when every shard is on one device, else a ShardedBlocks."""
    if len(set(devices)) == 1:
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return ShardedBlocks(parts)


def alloc_lane(shape: tuple, dtype: torch.dtype, devices: tuple) -> Lane:
    """An uninitialized [D, ...] lane with shard s on ``devices[s]``."""
    if len(set(devices)) == 1:
        return torch.empty(shape, dtype=dtype, device=devices[0])
    return ShardedBlocks(torch.empty((1,) + tuple(shape[1:]), dtype=dtype, device=dev)
                         for dev in devices)


@dataclasses.dataclass
class StagedColumns:
    """Columns resident on the mesh's devices."""

    blocks: dict[str, Lane]  # name -> [D, nblk, B]
    mask: Lane  # [D, nblk, B] bool, False on padding
    num_rows: int
    block_rows: int
    # name -> offset of the frame-of-reference narrowed int columns.
    narrow_offsets: dict = dataclasses.field(default_factory=dict)
    # [D, nblk, B] host-densified group ids (uint8/uint16/int32), or None.
    gids: Optional[Lane] = None
    # Int-dictionary columns: blocks[name] holds small-domain CODES
    # (uint8/uint16) and int_dicts[name] is the [C] int64 value LUT; the
    # cell lane aggregates per (group, code) cell instead of per row.
    int_dicts: dict = dataclasses.field(default_factory=dict)
    # The device of each shard (len D); empty: every shard on the mask's.
    devices: tuple = ()

    @property
    def num_blocks(self) -> int:
        """Blocks per shard."""
        return self.mask.shape[1]

    @property
    def num_shards(self) -> int:
        return self.mask.shape[0]

    def shard_device(self, s: int) -> torch.device:
        return self.devices[s] if self.devices else shard_of(self.mask, s).device

    def shard(self, s: int) -> "StagedColumns":
        """Shard ``s`` as a one-shard staging ([1, nblk, B] lanes on its
        device): the rows it holds, in their order. Itself when D is 1."""
        if self.num_shards == 1:
            return self
        return dataclasses.replace(
            self,
            blocks={k: shard_of(v, s) for k, v in self.blocks.items()},
            mask=shard_of(self.mask, s),
            gids=shard_of(self.gids, s) if self.gids is not None else None,
            devices=(self.shard_device(s),),
        )


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
    cols, n, _, _ = read_columns_windowed(table, columns, start_time, stop_time,
                                          want_windows=False)
    return cols, n


def read_columns_windowed(
    table: Table,
    columns: list[str],
    start_time: Optional[int] = None,
    stop_time: Optional[int] = None,
    want_windows: bool = True,
):
    """``read_columns`` plus each row's window id from the cursor's
    end-of-window markers (pixie_tpu/parallel/staging.py:185): a batch with
    ``eow`` closes the current window, with or without rows (the boundaries
    the host AggNode emits on), and the rows after the last ``eow`` form a
    final, unclosed window. Returns (cols, n, window ids int64 or None,
    n_windows)."""
    batches = []
    cur = table.cursor(start_time, stop_time)
    while not cur.done():
        b = cur.next_batch()
        if b is None:
            break
        if b.num_rows or b.eow:
            batches.append(b)
    cols: dict[str, np.ndarray] = {}
    for name in columns:
        parts = []
        for b in batches:
            if b.num_rows:
                c = b.col(name)
                parts.append(c.codes if isinstance(c, DictColumn) else np.asarray(c))
        cols[name] = np.concatenate(parts) if parts else np.empty(0, np.int32)
    n = sum(b.num_rows for b in batches)
    if not want_windows:
        return cols, n, None, 1
    parts, w = [], 0
    for b in batches:
        if b.num_rows:
            parts.append(np.full(b.num_rows, w, np.int64))
        if b.eow:
            w += 1
    wids = np.concatenate(parts) if parts else np.empty(0, np.int64)
    n_windows = w + 1 if not batches or not batches[-1].eow else w
    return cols, n, wids, max(n_windows, 1)


def int_dict_encode(arr: np.ndarray, max_card: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(codes, sorted value LUT) when the INT64 column has <= max_card
    distinct values, else None: one sample unique, one searchsorted and one
    verifying compare over the column (pixie_tpu/parallel/staging.py:237)."""
    if arr.size == 0 or arr.dtype != np.int64 or max_card < 2:
        return None
    lut = np.unique(arr[: 1 << 16])
    if len(lut) > max_card:
        return None
    codes = np.searchsorted(lut, arr)
    codes = np.minimum(codes, len(lut) - 1)
    ok = lut[codes] == arr
    if not ok.all():
        extra = np.unique(arr[~ok])
        lut = np.unique(np.concatenate([lut, extra]))
        if len(lut) > max_card:
            return None
        codes = np.searchsorted(lut, arr)
    dtype = np.uint8 if len(lut) <= 256 else np.uint16
    return codes.astype(dtype), lut


def int_dict_lut(arr: np.ndarray, max_card: int) -> Optional[np.ndarray]:
    """The sorted value LUT when the FULL column's value set fits max_card,
    else None: every window's searchsorted against it is then exact."""
    enc = int_dict_encode(arr, max_card)
    return None if enc is None else enc[1]


def _narrow_int(arr: np.ndarray) -> tuple[np.ndarray, Optional[int]]:
    """Frame-of-reference narrowing of int64 values and int32 dictionary
    codes: (value - min) as uint8/uint16 (or int32 for int64 inputs) when
    the range fits; (arr, None) when it does not."""
    dt, off = _narrow_int_plan(arr)
    if off is None:
        return arr, None
    return (arr - off).astype(dt), off


def _narrow_int_plan(arr: np.ndarray) -> tuple[np.dtype, Optional[int]]:
    """``_narrow_int``'s decision without the conversion: (dtype, offset),
    offset None meaning as-is. Taken once over the full column, so every
    window narrows alike."""
    if arr.size == 0 or arr.dtype not in (np.int64, np.int32):
        return arr.dtype, None
    lo = int(arr.min())
    rng = int(arr.max()) - lo
    if rng <= 0xFF:
        return np.dtype(np.uint8), lo
    if rng <= 0xFFFF:
        return np.dtype(np.uint16), lo
    if arr.dtype == np.int64 and rng < (1 << 31):
        return np.dtype(np.int32), lo
    return arr.dtype, None


def _gid_dtype(num_groups: int) -> np.dtype:
    """Dense gids ship as uint8/uint16 when the group count fits; the fold
    widens them to int32 per block."""
    if num_groups <= 0xFF + 1:
        return np.dtype(np.uint8)
    if num_groups <= 0xFFFF + 1:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def _narrow_gids(gids: np.ndarray, num_groups: int) -> np.ndarray:
    """The host gids in their staged dtype."""
    return gids.astype(_gid_dtype(num_groups))


def build_mask(nblk: int, b: int, num_rows: int, device) -> Lane:
    """Validity mask [D, nblk, b] computed on each shard's device (flat index
    < num_rows, shard s holding flat indices from s * nblk * b), so no mask
    bytes cross the host link (pixie_tpu/parallel/staging.py:289-310).
    ``device`` is one device (D = 1) or the shards' devices."""
    devices = as_devices(device)
    span = nblk * b
    parts = [
        ((torch.arange(span, device=dev) + s * span) < num_rows).reshape(1, nblk, b)
        for s, dev in enumerate(devices)
    ]
    return lane_from_parts(parts, devices)


def _shard_packed(packed, s: int, d: int):
    """Shard ``s`` (of ``d``) of a packed array: a raw array's s-th row of
    d, or a CodecPayload cut to that shard's arrays under a one-shard plan."""
    if isinstance(packed, codec.CodecPayload):
        plan = dataclasses.replace(packed.plan, d=1)
        return codec.CodecPayload(plan, tuple(a[s : s + 1] for a in packed.arrays))
    return packed.reshape(d, -1)[s : s + 1]


def split_targets(packed, out: Lane) -> list:
    """[(packed part, destination)] that land ``packed`` in ``out``, each
    destination on one device, and contiguous where it is decoded: the whole
    lane at once where it is one tensor (a decode needs it contiguous: a
    window's slice of a one-device lane of D > 1 shards is not), else one
    pair a shard."""
    if isinstance(out, ShardedBlocks):
        return [(_shard_packed(packed, s, len(out.parts)), p) for s, p in enumerate(out.parts)]
    if isinstance(packed, codec.CodecPayload) and not out.is_contiguous():
        d = out.shape[0]
        return [(_shard_packed(packed, s, d), out[s : s + 1]) for s in range(d)]
    return [(packed, out)]


def land(packed, out: Lane) -> None:
    """Land one packed array in ``out`` (a [D, nblk, b] lane or a window's
    slice of one) with synchronous copies: a raw ndarray as it is; a
    CodecPayload (what ``encode_window`` made) by copying its arrays and
    decoding them on each shard's device into ``out``, bit for bit the raw
    copy."""
    for part, dst in split_targets(packed, out):
        if isinstance(part, codec.CodecPayload):
            with timed("stage_transfer"):
                args = [torch.from_numpy(a).to(dst.device) for a in part.arrays]
            with timed("stage_decode"):
                codec.decode(args, part.plan, dst.view(part.plan.d, part.plan.shard_len))
            continue
        with timed("stage_transfer"):
            dst.copy_(torch.from_numpy(part).reshape(dst.shape))


def _encode_or_none(flat: np.ndarray, plan: Optional[codec.CodecPlan], rows: int):
    """The payload of ``flat`` under ``plan``, or None (no plan, or a window
    that defeats it, which then ships raw and counts the ``codec_overflow``
    lane: the reference's per-window choice, staging.py:373-376)."""
    if plan is None:
        return None
    try:
        with timed("stage_encode"):
            return codec.encode_window(flat, plan, rows)
    except codec.CodecOverflow:
        segment.lane_count("codec_overflow")
        return None


def stage_columns(
    cols: dict[str, np.ndarray],
    num_rows: int,
    device,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    f32_cols: Optional[set] = None,
    gids: Optional[np.ndarray] = None,
    num_groups: int = 0,
    int_dicts: Optional[dict] = None,
) -> StagedColumns:
    """Pad/reshape host columns (and host-densified ``gids`` of
    ``num_groups`` groups, when given) into [D, nblk, B] blocks in one
    piece, shard s on the s-th of ``device`` (one device, D = 1, or the
    mesh's devices). ``int_dicts`` maps the columns already replaced by
    small-domain codes (``int_dict_encode``) to their value LUTs. With
    ``staging_codec`` every column and the gid lane ship encoded where an
    encoder pays (plan_codec_local on the packed column, per shard)."""
    devices = as_devices(device)
    d = len(devices)
    b, nblk = block_geometry(num_rows, d, block_rows)
    total = d * nblk * b
    use_codec = flags.staging_codec and num_rows > 0

    def put(a: np.ndarray) -> Lane:
        with timed("stage_host_pack"):
            flat = np.zeros(total, dtype=a.dtype if a.size else np.int32)
            flat[:num_rows] = a
        profile_add("stage_bytes", flat.nbytes)
        payload = None
        if use_codec:
            with timed("stage_encode"):
                plan = codec.plan_codec_local(flat, d, nblk, b, num_rows, codec_min_ratio())
            payload = _encode_or_none(flat, plan, num_rows)
        out = alloc_lane((d, nblk, b), codec.TORCH_DTYPES[flat.dtype], devices)
        land(payload if payload is not None else flat, out)
        profile_add("wire_bytes", payload.nbytes if payload is not None else flat.nbytes)
        return out

    narrow_offsets: dict[str, int] = {}
    blocks: dict[str, Lane] = {}
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
        mask=build_mask(nblk, b, num_rows, devices),
        num_rows=num_rows,
        block_rows=b,
        narrow_offsets=narrow_offsets,
        gids=staged_gids,
        int_dicts=dict(int_dicts or {}),
        devices=devices,
    )


def _shard_mask(nblk: int, b: int, d_host: int, shard_rows: np.ndarray, devices: tuple) -> Lane:
    """The partitioned staging's mask (pixie_tpu/parallel/staging.py:493):
    shard s belongs to host s // d_host, whose region of d_host shards is
    valid up to that host's row count: a ragged host pads at the tail of
    its own region. An iota compare on each shard's device."""
    span = nblk * b
    parts = [
        ((torch.arange(span, device=dev) + (s % d_host) * span)
         < int(shard_rows[s // d_host])).reshape(1, nblk, b)
        for s, dev in enumerate(devices)
    ]
    return lane_from_parts(parts, devices)


def stage_partitioned(
    mesh,
    cols: dict[str, np.ndarray],
    gids: np.ndarray,
    shard_rows: np.ndarray,
    num_groups: int,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> StagedColumns:
    """Stage host columns so each hosts-axis shard owns a contiguous region
    of devices (pixie_tpu/parallel/staging.py:514, the partitioned join's
    layout). ``cols`` and ``gids`` arrive permuted shard-major (host h's
    rows contiguous, in their original order) with ``shard_rows[h]`` rows
    of host h. Every host gets the ``block_geometry`` of the LARGEST shard
    over its d/H devices, so the regions are uniform, and a ragged shard
    pads at the tail of its own region (``_shard_mask``). Narrowing is
    ``stage_columns``': one frame-of-reference offset per column over the
    whole permuted array. There is no staging codec on this path, as in the
    reference. Each column packs into one host buffer (pinned when the mesh
    is on CUDA), and shard i copies from it to ``mesh.devices[i]``."""
    devices = tuple(mesh.devices)
    H = int(mesh.shape[0])
    d = len(devices)
    d_host = d // H
    shard_rows = np.asarray(shard_rows, np.int64)
    if shard_rows.shape != (H,) or int(shard_rows.sum()) != len(gids):
        raise ValueError(f"shard_rows {shard_rows.tolist()} do not cover {len(gids)} rows")
    b, nblk = block_geometry(int(max(shard_rows.max(), 1)), d_host, block_rows)
    region = d_host * nblk * b
    total = d * nblk * b
    offs = np.concatenate([[0], np.cumsum(shard_rows)[:-1]])
    cuda = devices[0].type == "cuda"
    pinned = []  # the host buffers, alive until their copies are done

    def put(a: np.ndarray) -> Lane:
        dtype = a.dtype if a.size else np.dtype(np.int32)
        with timed("stage_host_pack"):
            buf = torch.zeros(total, dtype=codec.TORCH_DTYPES[dtype], pin_memory=cuda)
            flat = buf.numpy()
            for h in range(H):
                r = int(shard_rows[h])
                flat[h * region : h * region + r] = a[offs[h] : offs[h] + r]
        pinned.append(buf)
        profile_add("stage_bytes", flat.nbytes)
        profile_add("wire_bytes", flat.nbytes)
        out = alloc_lane((d, nblk, b), buf.dtype, devices)
        src = buf.view(d, nblk, b)
        with timed("stage_transfer"):
            if isinstance(out, ShardedBlocks):
                for s, part in enumerate(out.parts):
                    part.copy_(src[s : s + 1], non_blocking=cuda)
            else:
                out.copy_(src, non_blocking=cuda)
        return out

    narrow_offsets: dict[str, int] = {}
    blocks: dict[str, Lane] = {}
    for name, a in cols.items():
        with timed("stage_host_pack"):
            a, off = _narrow_int(np.asarray(a))
        if off is not None:
            narrow_offsets[name] = off
        blocks[name] = put(a)
    staged_gids = put(_narrow_gids(np.asarray(gids), num_groups))
    if cuda:
        with timed("stage_transfer"):
            for dev in dict.fromkeys(devices):
                torch.cuda.synchronize(dev)
    return StagedColumns(
        blocks=blocks,
        mask=_shard_mask(nblk, b, d_host, shard_rows, devices),
        num_rows=int(shard_rows.sum()),
        block_rows=b,
        narrow_offsets=narrow_offsets,
        gids=staged_gids,
        devices=devices,
    )


# -- the streamed cold path ----------------------------------------------------
#
# The monolithic path stages the WHOLE table before the first fold; the
# stream cuts it into fixed row windows: window k+1 packs on a background
# thread while window k copies and folds, so a cold query costs about
# max(pack, copy, fold) plus one window. Every window shares one pack recipe
# (dtypes, offsets, LUTs and codec plans fixed from the FULL columns), so
# every window's blocks have one geometry and the windows together are a
# valid staging for the warm cache.


@dataclasses.dataclass
class StreamPlan:
    """Per-column pack recipe + window geometry, fixed across windows
    (pixie_tpu/parallel/staging.py:608).

    col_plans[name] is one of ("raw", None), ("f32", None),
    ("narrow", (np_dtype, offset)), ("intdict", (lut, np_dtype)); ``codecs``
    the columns that ship encoded (absent: passthrough); ``gid_codec`` the
    gid lane's plan, or None."""

    col_plans: dict
    narrow_offsets: dict  # name -> int offset (frame of reference)
    int_dicts: dict  # name -> [C] int64 value LUT
    block_dtypes: dict  # name -> np.dtype of the staged blocks
    window_rows: int
    num_rows: int
    n_windows: int
    d: int
    nblk: int  # blocks per window
    b: int
    gid_dtype: Optional[np.dtype]
    num_groups: int
    codecs: dict = dataclasses.field(default_factory=dict)
    gid_codec: Optional[codec.CodecPlan] = None

    def window_block_nbytes(self) -> int:
        """Decoded bytes per full window: the column blocks only (what
        stage_bytes counts per window; the gids count separately)."""
        return sum(
            self.d * self.nblk * self.b * np.dtype(dt).itemsize
            for dt in self.block_dtypes.values()
        )

    def rows_of(self, w: int) -> int:
        """The rows of window ``w``."""
        return max(min(self.window_rows, self.num_rows - w * self.window_rows), 0)


def plan_stream(
    cols: dict[str, np.ndarray],
    num_rows: int,
    window_rows: int,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    f32_cols: Optional[set] = None,
    cell_cols: Optional[dict] = None,
    num_groups: int = 1,
    has_gids: bool = False,
    gids: Optional[np.ndarray] = None,
    d: int = 1,
) -> StreamPlan:
    """Fix the pack recipe and window geometry of a streamed staging over
    ``d`` shards (pixie_tpu/parallel/staging.py:676): each window is
    [d, nblk, b], shard s holding the window's rows from s * nblk * b.

    window_rows is clamped to the table (to its pow2-padded row count under
    ``signature_buckets``), so a small table is ONE window whose geometry is
    the monolithic one, and a window that is a multiple of the block size
    cuts the table into the monolithic blocks."""
    clamp = max(num_rows, 1)
    if flags.signature_buckets:
        clamp = _pow2_at_least(clamp, floor=1)
    window_rows = max(min(int(window_rows), clamp), 1)
    n_windows = max((num_rows + window_rows - 1) // window_rows, 1)
    b, nblk = block_geometry(window_rows, d, block_rows)
    col_plans: dict = {}
    narrow_offsets: dict = {}
    int_dicts: dict = {}
    block_dtypes: dict = {}
    for name, a in cols.items():
        if cell_cols and name in cell_cols:
            lut = int_dict_lut(a, cell_cols[name])
            if lut is not None:
                dt = np.dtype(np.uint8 if len(lut) <= 256 else np.uint16)
                col_plans[name] = ("intdict", (lut, dt))
                int_dicts[name] = lut
                block_dtypes[name] = dt
                continue
        if f32_cols and name in f32_cols and a.dtype == np.float64:
            col_plans[name] = ("f32", None)
            block_dtypes[name] = np.dtype(np.float32)
            continue
        dt, off = _narrow_int_plan(a)
        if off is not None:
            col_plans[name] = ("narrow", (dt, off))
            narrow_offsets[name] = off
            block_dtypes[name] = dt
        else:
            col_plans[name] = ("raw", None)
            block_dtypes[name] = np.dtype(a.dtype) if a.size else np.dtype(np.int32)
    gid_dtype = _gid_dtype(num_groups) if has_gids else None
    # The codec plans come from the FULL column's statistics, so every
    # window encodes alike. Delta needs a diff-preserving transform (raw or
    # narrowed int); RLE composes with every transform (run boundaries map
    # one to one).
    codecs: dict = {}
    gid_codec = None
    if flags.staging_codec:
        for name, a in cols.items():
            kind = col_plans[name][0]
            bdt = np.dtype(block_dtypes[name])
            affine = kind in ("raw", "narrow") and bdt.kind in "iu"
            cp = codec.plan_codec(
                a, bdt, d, nblk, b, window_rows, num_rows, codec_min_ratio(), affine
            )
            if cp is not None:
                codecs[name] = cp
        if gids is not None and gid_dtype is not None and gids.size:
            # The narrowing cast keeps run boundaries and diffs, so the raw
            # gids' statistics are exact.
            gid_codec = codec.plan_codec(
                gids, gid_dtype, d, nblk, b, window_rows, num_rows,
                codec_min_ratio(), affine=True,
            )
    return StreamPlan(
        col_plans=col_plans, narrow_offsets=narrow_offsets, int_dicts=int_dicts,
        block_dtypes=block_dtypes, window_rows=window_rows, num_rows=num_rows,
        n_windows=n_windows, d=d, nblk=nblk, b=b, gid_dtype=gid_dtype,
        num_groups=num_groups, codecs=codecs, gid_codec=gid_codec,
    )


def _np_empty(n: int, dtype) -> np.ndarray:
    return np.empty(n, dtype=dtype)


def pack_stream_window(
    plan: StreamPlan,
    cols: dict[str, np.ndarray],
    gids: Optional[np.ndarray],
    w: int,
    alloc: Optional[Callable[[int, np.dtype], np.ndarray]] = None,
    skip_cols: bool = False,
):
    """Host-pack window ``w`` per the plan (pixie_tpu/parallel/staging.py:
    788): narrow / f32 / int-dict encode, pad, reshape to [d, nblk, b], and
    encode where the plan has a codec. Runs on the stream's background
    thread. Returns (rows, packed_cols, packed_gids, wire_nbytes); a packed
    value is an ndarray or a CodecPayload, and wire_nbytes counts what
    ships. ``alloc(n, dtype)`` places each raw block (a pinned buffer on
    CUDA); by default np.empty. ``skip_cols`` packs only the gids: the
    resident-ingest hit, whose columns are already on the device."""
    if faults.ACTIVE:
        faults.check("staging.pack")
    alloc = alloc or _np_empty
    with timed("stage_stream_pack"):
        lo = w * plan.window_rows
        hi = min(lo + plan.window_rows, plan.num_rows)
        rows = hi - lo
        total = plan.d * plan.nblk * plan.b

        def flat_pad(a, dtype, place=_np_empty):
            out = place(total, dtype)
            out[:rows] = a
            if rows < total:
                out[rows:] = 0
            return out

        def encoded_or_raw(a, dtype, cp):
            if cp is not None:
                flat = flat_pad(a, dtype)
                payload = _encode_or_none(flat, cp, rows)
                if payload is not None:
                    return payload
                return flat.reshape(plan.d, plan.nblk, plan.b)
            return flat_pad(a, dtype, alloc).reshape(plan.d, plan.nblk, plan.b)

        packed: dict = {}
        nbytes = 0
        for name, arr in ({} if skip_cols else cols).items():
            a = arr[lo:hi]
            kind, info = plan.col_plans[name]
            if kind == "f32":
                a = a.astype(np.float32)
            elif kind == "narrow":
                dt, off = info
                a = (a - off).astype(dt)
            elif kind == "intdict":
                lut, dt = info
                a = np.minimum(np.searchsorted(lut, a), len(lut) - 1).astype(dt)
            packed[name] = encoded_or_raw(a, plan.block_dtypes[name], plan.codecs.get(name))
            nbytes += packed[name].nbytes
        packed_gids = None
        if gids is not None:
            packed_gids = encoded_or_raw(
                gids[lo:hi].astype(plan.gid_dtype), plan.gid_dtype, plan.gid_codec
            )
            nbytes += packed_gids.nbytes
        return rows, packed, packed_gids, nbytes


def put_window_gids(pgids, out: torch.Tensor) -> None:
    """Land one window's packed gids in ``out`` (its slice of the staged gid
    lane): a raw block as it is, a CodecPayload decoded on the device, bit
    for bit the raw copy (pixie_tpu/parallel/staging.py:886)."""
    if pgids is not None:
        land(pgids, out)


def staged_gid_nbytes(pgids) -> int:
    """Decoded (device) bytes a packed gid lane lands as: the stage_bytes
    view (``nbytes`` of a CodecPayload is wire bytes)."""
    if pgids is None:
        return 0
    if isinstance(pgids, codec.CodecPayload):
        return pgids.plan.block_nbytes()
    return int(pgids.nbytes)


def _stream_padding(plan: StreamPlan) -> int:
    """Blocks appended after the windows: the concatenated block count is
    rounded up to its bucket under ``signature_buckets``."""
    total = plan.n_windows * plan.nblk
    return bucket_block_count(total) - total if flags.signature_buckets else 0


def _stream_mask(plan: StreamPlan, s: int, device, pad: int) -> torch.Tensor:
    """Shard ``s``'s [1, n_windows * nblk + pad, b] mask of a streamed
    staging: in window w, flat index s * nblk * b + i is valid below that
    window's rows; the padding blocks are invalid."""
    span = plan.nblk * plan.b
    rows = torch.tensor([plan.rows_of(w) for w in range(plan.n_windows)], device=device)
    idx = torch.arange(span, device=device) + s * span
    mask = (idx[None, :] < rows[:, None]).reshape(1, plan.n_windows * plan.nblk, plan.b)
    if pad:
        mask = torch.cat(
            [mask, torch.zeros((1, pad, plan.b), dtype=torch.bool, device=device)], dim=1
        )
    return mask


def alloc_stream_staging(plan: StreamPlan, device) -> StagedColumns:
    """The warm-cache entry of a streamed staging, allocated once: every
    column's (and the gid lane's) [d, n_windows * nblk + pad, b] lane (shard
    s on the s-th of ``device``), each window's slice to be landed by a copy
    or a decode, the bucket padding zeroed, and the per-window mask (flat
    index < that window's rows) built on each shard's device.
    ``concat_stream_windows`` is its one-device counterpart from per-window
    blocks: the same entry, at the cost of a second copy."""
    devices = as_devices(device)
    if len(devices) != plan.d:
        raise ValueError(f"a plan of {plan.d} shards on {len(devices)} devices")
    nblk_total = plan.n_windows * plan.nblk
    pad = _stream_padding(plan)
    shape = (plan.d, nblk_total + pad, plan.b)

    def block(dtype) -> Lane:
        lane = alloc_lane(shape, codec.TORCH_DTYPES[np.dtype(dtype)], devices)
        if pad:
            for s in range(plan.d):
                shard_of(lane, s)[0, nblk_total:].zero_()
        return lane

    return StagedColumns(
        blocks={name: block(dt) for name, dt in plan.block_dtypes.items()},
        mask=lane_from_parts(
            [_stream_mask(plan, s, dev, pad) for s, dev in enumerate(devices)], devices
        ),
        num_rows=plan.num_rows,
        block_rows=plan.b,
        narrow_offsets=dict(plan.narrow_offsets),
        gids=block(plan.gid_dtype) if plan.gid_dtype is not None else None,
        int_dicts=dict(plan.int_dicts),
        devices=devices,
    )


def concat_stream_windows(
    plan: StreamPlan, win_blocks: list, win_masks: list, win_gids: list
) -> StagedColumns:
    """Assemble per-window device blocks ([1, nblk, b] each) into one
    StagedColumns: the windows concatenated along the block axis, then
    zero blocks (masked) up to the bucket (pixie_tpu/parallel/staging.py:
    916, 929, 941). The stream builds the same entry without this second
    copy (``alloc_stream_staging``, each window landed in its slice); this
    is the named counterpart the tests hold it against."""
    pad = _stream_padding(plan)

    def cat(parts: list, dtype) -> torch.Tensor:
        if pad:
            parts = list(parts) + [torch.zeros(
                (1, pad, plan.b), dtype=dtype, device=parts[0].device
            )]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    blocks = {
        name: cat([wb[name] for wb in win_blocks], win_blocks[0][name].dtype)
        for name in win_blocks[0]
    }
    gids = None
    if win_gids and win_gids[0] is not None:
        gids = cat(list(win_gids), win_gids[0].dtype)
    return StagedColumns(
        blocks=blocks,
        mask=cat(list(win_masks), torch.bool),
        num_rows=plan.num_rows,
        block_rows=plan.b,
        narrow_offsets=dict(plan.narrow_offsets),
        gids=gids,
        int_dicts=dict(plan.int_dicts),
    )


class _Arena:
    """Bump allocation of numpy views on one pinned host buffer."""

    ALIGN = 64

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.host = buf.numpy()
        self.off = 0

    def alloc(self, n: int, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        start = -(-self.off // self.ALIGN) * self.ALIGN
        end = start + n * dtype.itemsize
        if end > self.host.size:
            raise RuntimeError(f"stream pack buffer of {self.host.size} B overflowed ({end} B)")
        self.off = end
        return self.host[start:end].view(dtype)

    def adopt(self, packed):
        """``packed`` with every array in this buffer (copied in where it
        is not)."""
        if isinstance(packed, codec.CodecPayload):
            return codec.CodecPayload(packed.plan, tuple(self._copy_in(a) for a in packed.arrays))
        if packed is None or np.may_share_memory(packed, self.host):
            return packed
        return self._copy_in(packed)

    def _copy_in(self, a: np.ndarray) -> np.ndarray:
        out = self.alloc(a.size, a.dtype).reshape(a.shape)
        np.copyto(out, a)
        return out

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        """The pinned torch view of an array of this buffer."""
        off = a.__array_interface__["data"][0] - self.host.__array_interface__["data"][0]
        return self.buf[off : off + a.nbytes].view(codec.TORCH_DTYPES[a.dtype]).reshape(a.shape)


@dataclasses.dataclass
class PackedWindow:
    """One window as the pack thread left it."""

    w: int
    rows: int
    packed: dict
    gids: object
    wire_nbytes: int
    arena: Optional[_Arena] = None


class WindowStager:
    """Lands a StreamPlan's windows in one preallocated staging on the
    shards' devices (``alloc_stream_staging``).

    On CUDA: ``pack`` (the stream's background thread) packs window w into
    pinned host buffer w % 2, after that buffer's last copy events
    completed; ``put`` copies each shard's part of the window on a side
    stream of the shard's device with ``non_blocking=True``, records a copy
    event there, makes that device's compute stream wait on it, and decodes
    the encoded arrays there into the window's slice. Payload tensors made
    on a side stream and used on the compute stream are marked with
    ``record_stream``, as is the staging itself, which the side streams
    write. On the CPU both are synchronous (``land``)."""

    N_SLOTS = 2

    def __init__(self, plan: StreamPlan, device):
        devices = as_devices(device)
        self.plan = plan
        self.staged = alloc_stream_staging(plan, devices)
        self.cuda = devices[0].type == "cuda"
        if not self.cuda:
            return
        self.compute = {}
        self.copy_streams = {}
        for dev in dict.fromkeys(devices):
            self.compute[dev] = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            # The staging is allocated (and its padding zeroed) on the
            # compute stream; the side stream writes it.
            side.wait_stream(self.compute[dev])
            self.copy_streams[dev] = side
        for t in self._targets_all():
            t.record_stream(self.copy_streams[t.device])
        self.slots = [
            torch.empty(self._slot_nbytes(), dtype=torch.uint8, pin_memory=True)
            for _ in range(self.N_SLOTS)
        ]
        self.copied: list = [[] for _ in range(self.N_SLOTS)]

    def _targets_all(self) -> list:
        lanes = list(self.staged.blocks.values())
        lanes += [self.staged.gids] if self.staged.gids is not None else []
        out = []
        for lane in lanes:
            out += list(lane.parts) if isinstance(lane, ShardedBlocks) else [lane]
        return out

    def _slot_nbytes(self) -> int:
        plan = self.plan
        total = plan.d * plan.nblk * plan.b
        lanes = [(dt, plan.codecs.get(name)) for name, dt in plan.block_dtypes.items()]
        if plan.gid_dtype is not None:
            lanes.append((plan.gid_dtype, plan.gid_codec))
        nbytes = 0
        for dt, cp in lanes:
            nbytes += total * np.dtype(dt).itemsize + 4 * _Arena.ALIGN
            if cp is not None:
                nbytes += cp.wire_nbytes()
        return nbytes

    def pack(self, cols: dict, gids: Optional[np.ndarray], w: int,
             skip_cols: bool = False) -> PackedWindow:
        """Window ``w`` packed (with ``skip_cols``, its gids only: a resident
        hit, whose columns the executor converts on the device)."""
        if not self.cuda:
            return PackedWindow(w, *pack_stream_window(self.plan, cols, gids, w,
                                                       skip_cols=skip_cols))
        k = w % self.N_SLOTS
        for event in self.copied[k]:
            event.synchronize()  # its last copies have left the buffer
        arena = _Arena(self.slots[k])
        rows, packed, pgids, nbytes = pack_stream_window(
            self.plan, cols, gids, w, arena.alloc, skip_cols=skip_cols
        )
        packed = {name: arena.adopt(v) for name, v in packed.items()}
        return PackedWindow(w, rows, packed, arena.adopt(pgids), nbytes, arena)

    def put(self, win: PackedWindow) -> None:
        """Land window ``win``'s packed arrays (its columns unless it was
        packed with ``skip_cols``, and its gids) in its slice of the
        staging."""
        plan, staged = self.plan, self.staged
        lo, hi = win.w * plan.nblk, (win.w + 1) * plan.nblk
        targets = [(win.packed[name], staged.blocks[name][:, lo:hi]) for name in win.packed]
        if win.gids is not None:
            targets.append((win.gids, staged.gids[:, lo:hi]))
        if not self.cuda:
            for packed, out in targets:
                land(packed, out)
            return
        by_device: dict = {}
        for packed, out in targets:
            for part, dst in split_targets(packed, out):
                by_device.setdefault(dst.device, []).append((part, dst))
        arena = win.arena
        events, decodes = [], []
        with timed("stage_transfer"):
            for dev, pairs in by_device.items():
                with torch.cuda.stream(self.copy_streams[dev]):
                    for packed, out in pairs:
                        if isinstance(packed, codec.CodecPayload):
                            args = []
                            for a in packed.arrays:
                                t = torch.empty(a.shape, dtype=codec.TORCH_DTYPES[a.dtype],
                                                device=dev)
                                t.copy_(arena.tensor(a), non_blocking=True)
                                args.append(t)
                            decodes.append((args, packed.plan, out))
                        else:
                            out.copy_(arena.tensor(packed).reshape(out.shape), non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self.copy_streams[dev])
                self.compute[dev].wait_event(event)
                events.append(event)
        self.copied[win.w % self.N_SLOTS] = events
        with timed("stage_decode"):
            for args, cp, out in decodes:
                with torch.cuda.device(out.device):
                    for t in args:
                        t.record_stream(self.compute[out.device])
                    codec.decode(args, cp, out.view(cp.d, cp.shard_len))
