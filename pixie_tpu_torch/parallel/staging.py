"""Host -> device staging: table columns -> padded blocks on one CUDA device.

Counterpart of pixie_tpu/parallel/staging.py for one device: columns are
read through a table cursor, int columns whose value range fits are narrowed
to uint8/uint16/int32 of (value - offset) (frame of reference, widened back
to int64 per block on the device), float64 columns read only by f32-grained
sketches stage as float32, small-domain INT64 columns read only by
cell-capable sketches stage as uint8/uint16 codes of a value LUT (the
int-dictionary cell lane), and everything is padded to [1, nblk, B] blocks
with a validity mask built on the device. Group ids densified on the host
(multi-column and non-dictionary keys) stage as one more per-block lane,
narrowed to uint8/uint16 when the group count fits. The block geometry is
the reference's, so both packages cut a table into the same blocks.

With ``staging_codec`` (on by default, as in the reference) a packed column
or gid lane ships encoded when RLE or delta pays (ops/codec.py) and is
decoded on the device into the block the raw copy would have landed (H18,
H19). ``stage_columns`` stages a table in one piece; the streamed cold path
(``plan_stream``, ``pack_stream_window``, ``WindowStager``) packs window
k+1 on a background thread into a pinned buffer while window k copies on a
side stream and folds, and lands every window in its slice of one
preallocated staging, which becomes the warm-cache entry. Strings never
leave the host: their int32 dictionary codes do.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

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
    # Int-dictionary columns: blocks[name] holds small-domain CODES
    # (uint8/uint16) and int_dicts[name] is the [C] int64 value LUT; the
    # cell lane aggregates per (group, code) cell instead of per row.
    int_dicts: dict = dataclasses.field(default_factory=dict)

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


def build_mask(nblk: int, b: int, num_rows: int, device) -> torch.Tensor:
    """Validity mask [1, nblk, b] computed on the device (iota < num_rows),
    so no mask bytes cross the host link."""
    return (torch.arange(nblk * b, device=device) < num_rows).reshape(1, nblk, b)


def land(packed, out: torch.Tensor) -> None:
    """Land one packed array in ``out`` (a [1, nblk, b] block or a window's
    slice of one) with a synchronous copy: a raw ndarray as it is; a
    CodecPayload (what ``encode_window`` made) by copying its arrays and
    decoding them on the device into ``out``, bit for bit the raw copy."""
    if isinstance(packed, codec.CodecPayload):
        with timed("stage_transfer"):
            args = [torch.from_numpy(a).to(out.device) for a in packed.arrays]
        with timed("stage_decode"):
            codec.decode(args, packed.plan, out.view(packed.plan.d, packed.plan.shard_len))
        return
    with timed("stage_transfer"):
        out.copy_(torch.from_numpy(packed).reshape(out.shape))


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
    ``num_groups`` groups, when given) into [1, nblk, B] blocks on
    ``device`` in one piece. ``int_dicts`` maps the columns already replaced
    by small-domain codes (``int_dict_encode``) to their value LUTs. With
    ``staging_codec`` every column and the gid lane ship encoded where an
    encoder pays (plan_codec_local on the packed column)."""
    b, nblk = block_geometry(num_rows, 1, block_rows)
    total = nblk * b
    use_codec = flags.staging_codec and num_rows > 0

    def put(a: np.ndarray) -> torch.Tensor:
        with timed("stage_host_pack"):
            flat = np.zeros(total, dtype=a.dtype if a.size else np.int32)
            flat[:num_rows] = a
        profile_add("stage_bytes", flat.nbytes)
        payload = None
        if use_codec:
            with timed("stage_encode"):
                plan = codec.plan_codec_local(flat, 1, nblk, b, num_rows, codec_min_ratio())
            payload = _encode_or_none(flat, plan, num_rows)
        out = torch.empty((1, nblk, b), dtype=codec.TORCH_DTYPES[flat.dtype], device=device)
        land(payload if payload is not None else flat, out)
        profile_add("wire_bytes", payload.nbytes if payload is not None else flat.nbytes)
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
        int_dicts=dict(int_dicts or {}),
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
) -> StreamPlan:
    """Fix the pack recipe and window geometry of a streamed staging
    (pixie_tpu/parallel/staging.py:676, for one device).

    window_rows is clamped to the table (to its pow2-padded row count under
    ``signature_buckets``), so a small table is ONE window whose geometry is
    the monolithic one, and a window that is a multiple of the block size
    cuts the table into the monolithic blocks."""
    d = 1
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


def alloc_stream_staging(plan: StreamPlan, device) -> StagedColumns:
    """The warm-cache entry of a streamed staging, allocated once: every
    column's (and the gid lane's) [1, n_windows * nblk + pad, b] block, each
    window's slice to be landed by a copy or a decode, the bucket padding
    zeroed, and the per-window mask (row < that window's rows) built on the
    device. ``concat_stream_windows`` is its counterpart from per-window
    blocks: the same entry, at the cost of a second copy."""
    nblk_total = plan.n_windows * plan.nblk
    pad = _stream_padding(plan)
    shape = (1, nblk_total + pad, plan.b)

    def block(dtype) -> torch.Tensor:
        t = torch.empty(shape, dtype=codec.TORCH_DTYPES[np.dtype(dtype)], device=device)
        if pad:
            t[0, nblk_total:].zero_()
        return t

    rows = torch.tensor([plan.rows_of(w) for w in range(plan.n_windows)], device=device)
    idx = torch.arange(plan.nblk * plan.b, device=device)
    mask = (idx[None, :] < rows[:, None]).reshape(1, nblk_total, plan.b)
    if pad:
        mask = torch.cat(
            [mask, torch.zeros((1, pad, plan.b), dtype=torch.bool, device=device)], dim=1
        )
    return StagedColumns(
        blocks={name: block(dt) for name, dt in plan.block_dtypes.items()},
        mask=mask,
        num_rows=plan.num_rows,
        block_rows=plan.b,
        narrow_offsets=dict(plan.narrow_offsets),
        gids=block(plan.gid_dtype) if plan.gid_dtype is not None else None,
        int_dicts=dict(plan.int_dicts),
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
    """Lands a StreamPlan's windows in one preallocated staging on
    ``device`` (``alloc_stream_staging``).

    On CUDA: ``pack`` (the stream's background thread) packs window w into
    pinned host buffer w % 2, after that buffer's last copy event completed;
    ``put`` copies the window on a side stream with ``non_blocking=True``,
    records a copy event, makes the compute stream wait on it, and decodes
    the encoded arrays there into the window's slice. Payload tensors made
    on the side stream and used on the compute stream are marked with
    ``record_stream``, as is the staging itself, which the side stream
    writes. On the CPU both are synchronous (``land``)."""

    N_SLOTS = 2

    def __init__(self, plan: StreamPlan, device: torch.device):
        self.plan = plan
        self.staged = alloc_stream_staging(plan, device)
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        self.compute = torch.cuda.current_stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        # The staging is allocated (and its padding zeroed) on the compute
        # stream; the side stream writes it.
        self.copy_stream.wait_stream(self.compute)
        for t in self._targets_all():
            t.record_stream(self.copy_stream)
        self.slots = [
            torch.empty(self._slot_nbytes(), dtype=torch.uint8, pin_memory=True)
            for _ in range(self.N_SLOTS)
        ]
        self.copied: list = [None] * self.N_SLOTS

    def _targets_all(self) -> list:
        out = list(self.staged.blocks.values())
        return out + ([self.staged.gids] if self.staged.gids is not None else [])

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
        if self.copied[k] is not None:
            self.copied[k].synchronize()  # its last copy has left the buffer
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
        arena = win.arena
        decodes = []
        with timed("stage_transfer"), torch.cuda.stream(self.copy_stream):
            for packed, out in targets:
                if isinstance(packed, codec.CodecPayload):
                    args = []
                    for a in packed.arrays:
                        t = torch.empty(a.shape, dtype=codec.TORCH_DTYPES[a.dtype],
                                        device=out.device)
                        t.copy_(arena.tensor(a), non_blocking=True)
                        args.append(t)
                    decodes.append((args, packed.plan, out))
                else:
                    out.copy_(arena.tensor(packed).reshape(out.shape), non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        self.copied[win.w % self.N_SLOTS] = event
        self.compute.wait_event(event)
        with timed("stage_decode"):
            for args, cp, out in decodes:
                for t in args:
                    t.record_stream(self.compute)
                codec.decode(args, cp, out.view(cp.d, cp.shard_len))
