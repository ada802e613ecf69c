"""Staging codec: lightweight per-column compression with decode on the
device (pixie_tpu/ops/codec.py).

The host packs a column's window ENCODED when an encoder pays, the host ->
device copy carries the compressed payload, and the device expands it to the
block the uncompressed pack would have copied, bit for bit. Everything
downstream (the fold, the staged-column cache) is untouched.

- **RLE** (``rle``): per shard run values + cumulative run ends. Decode:
  ``out[i] = values[min(searchsorted(ends, i, right), R - 1)]``, copied as
  bits, so NaN payloads survive (runs are found on bit patterns).
- **Delta** (``delta``): per shard base + frame-of-reference deltas in the
  narrowest unsigned type that fits the column's delta range (``nib``: two
  4-bit deltas a byte, low nibble first). Decode: a masked int64 inclusive
  scan (wrapping adds, exact in any order) + a cast to the block dtype.

Both work on the PACKED column (after narrowing, the f32 cast or int-dict
encoding), so a decoded block equals the packed block by construction.

The host side (planning, encoding) is numpy and equals the reference's
payloads bit for bit. ``decode`` runs H18 (``codec_rle_decode``) or H19
(``codec_delta_decode``) of ``ops/kernels`` on CUDA tensors and the plain
versions below on CPU tensors.

The raw -> plan converters (the reference's ``_converter`` and
``convert_block``, K8) serve device-resident ingest (serving/resident.py):
a ring window holds RAW column dtypes, and a query's plan may narrow, cast
to f32 or int-dictionary-encode a column. ``convert_block`` computes the
plan-dtype block on the device, bit for bit the host pack of the same rows
(``pack_stream_window``): H24 (``ring_convert``) on CUDA tensors,
``convert_block_plain`` on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch.ops import kernels


class CodecOverflow(Exception):
    """A window's data exceeded the plan's encoded capacity (more runs than
    runs_cap, or a delta outside the planned range): that window ships
    raw."""


# Unsigned views for bit-pattern run detection: floats compare by bits, so
# NaN == NaN (payload-exact) and -0.0 != +0.0.
_BITVIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}

# Signed integer views of the same width: gathers copy bits through them
# (torch gathers no uint16, and a float gather must not touch NaN payloads).
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return a.view(_BITVIEW[a.dtype.itemsize])
    return a


def bucket_cap(n: int) -> int:
    """Round an encoded capacity up to its quarter-octave bucket (as
    staging.bucket_block_count), bounding the decode shapes to O(log)."""
    if n <= 8:
        return max(n, 1)
    step = 1 << ((n - 1).bit_length() - 3)
    return ((n + step - 1) // step) * step


@dataclasses.dataclass(frozen=True)
class CodecPlan:
    """Per-column encode/decode recipe, fixed across a staging's windows."""

    kind: str  # "rle" | "delta"
    dtype: str  # decoded (packed block) dtype str
    d: int  # device shards per window
    shard_len: int  # nblk * b elements per shard
    runs_cap: int = 0  # rle: padded runs per shard (bucketed)
    delta_dtype: str = ""  # delta: encoded delta dtype str ("nib" = u4x2)
    delta_off: int = 0  # delta: frame-of-reference offset on deltas

    def wire_nbytes(self) -> int:
        """Encoded bytes per window (what the copy carries)."""
        if self.kind == "rle":
            per = np.dtype(self.dtype).itemsize + 4  # values + i32 ends
            return self.d * self.runs_cap * per
        if self.delta_dtype == "nib":
            return self.d * ((self.shard_len + 1) // 2 + 8 + 4)
        per = np.dtype(self.delta_dtype).itemsize
        return self.d * (self.shard_len * per + 8 + 4)  # deltas+base+rows

    def block_nbytes(self) -> int:
        """Decoded bytes per window (what lands on the device)."""
        return self.d * self.shard_len * np.dtype(self.dtype).itemsize

    def sig(self) -> str:
        """The decode's identity (kind, dtypes, geometry, run capacity)."""
        if self.kind == "rle":
            return f"rle:{self.dtype}:d{self.d}:l{self.shard_len}:r{self.runs_cap}"
        return f"delta:{self.dtype}:{self.delta_dtype}:d{self.d}:l{self.shard_len}"


@dataclasses.dataclass
class CodecPayload:
    """One window's encoded column: the arrays the copy carries, in the
    decoder's order."""

    plan: CodecPlan
    arrays: tuple  # rle: (values, ends); delta: (bases, deltas, rows)

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays))


# -- planning ----------------------------------------------------------------


def _shard_bounds(num_rows: int, window_rows: int, shard_len: int, d: int) -> np.ndarray:
    """Start offsets of every (window, shard) slice of the row range, clipped
    to num_rows: the units encode works on."""
    n_windows = max((num_rows + window_rows - 1) // window_rows, 1)
    starts = []
    for w in range(n_windows):
        base = w * window_rows
        for s in range(d):
            starts.append(min(base + s * shard_len, num_rows))
    return np.asarray(starts, np.int64)


def _max_runs_per_shard(arr: np.ndarray, starts: np.ndarray) -> int:
    """Largest run count any shard sees, from one pass over the column."""
    if arr.size <= 1:
        return 1
    v = _bits(arr)
    chg = v[1:] != v[:-1]
    # Shard s covers [starts[s], starts[s+1]); runs <= changes in that span
    # + 1 (the span includes the shard's trailing boundary: an upper bound).
    idx = np.minimum(starts, chg.size - 1)
    counts = np.add.reduceat(chg, idx).astype(np.int64)
    # reduceat returns chg[idx] for an empty segment: zero it.
    width = np.diff(np.append(idx, chg.size))
    counts = np.where(width > 0, counts, 0)
    return int(counts.max()) + 1 if counts.size else 1


def _changes_exceed(arr: np.ndarray, end: int, cost_of) -> bool:
    """Whether the run changes among arr[:end + 1] already make RLE too dear:
    ``cost_of(changes)`` is the plan's cost given that many changes in the
    first shard (a lower bound of its runs), checked after each chunk. The
    count only grows, so a True is the full pass's answer; the pass stops
    as soon as it is known."""
    v = _bits(arr)
    count = 0
    chunk = 1 << 20
    for off in range(0, end, chunk):
        hi = min(off + chunk, end)
        count += int(np.count_nonzero(v[off + 1 : hi + 1] != v[off:hi]))
        if cost_of(count):
            return True
    return False


def _delta_range(arr: np.ndarray, stop_above: Optional[int] = None) -> tuple[int, int]:
    """(min, max) of consecutive diffs, chunked so the int64 temporary stays
    bounded; with ``stop_above`` it returns as soon as the range exceeds it
    (the range only grows, so the answer to "does it fit" is the same)."""
    lo, hi = 0, 0
    chunk = 1 << 24 if stop_above is None else 1 << 20
    first = True
    for off in range(0, arr.size - 1, chunk):
        a = arr[off : min(off + chunk + 1, arr.size)].astype(np.int64)
        dd = np.diff(a)
        if dd.size == 0:
            continue
        dmin, dmax = int(dd.min()), int(dd.max())
        if first:
            lo, hi = dmin, dmax
            first = False
        else:
            lo, hi = min(lo, dmin), max(hi, dmax)
        if stop_above is not None and hi - lo > stop_above:
            break
    return lo, hi


def _delta_dtype_for(rng: int) -> Optional[str]:
    """Narrowest delta representation for a delta range: "nib" below 16,
    else u8/u16; past 16 bits delta does not pay."""
    if rng <= 0xF:
        return "nib"
    if rng <= 0xFF:
        return np.dtype(np.uint8).str
    if rng <= 0xFFFF:
        return np.dtype(np.uint16).str
    return None


def plan_codec(
    arr: np.ndarray,
    block_dtype: np.dtype,
    d: int,
    nblk: int,
    b: int,
    window_rows: int,
    num_rows: int,
    min_ratio: float,
    affine: bool,
) -> Optional[CodecPlan]:
    """The cheapest encoder for a column, or None (passthrough).

    ``arr`` is the RAW host column: run boundaries survive the pack
    transforms and diffs survive affine shifts, so the packed column never
    materializes at plan time. ``affine`` (raw or narrowed int) enables
    delta; f32 and int-dict columns are RLE only. A column whose best
    encoder saves less than ``min_ratio`` ships passthrough.

    The plans are the reference's. Where a prefix already proves that an
    encoder cannot pay (too many run changes in the first shard; a delta
    range wider than every paying delta width), its full pass is skipped:
    the statistics only grow, so the answer is the same."""
    if arr.size == 0 or num_rows <= 0:
        return None
    block_dtype = np.dtype(block_dtype)
    shard_len = nblk * b
    block_bytes = block_dtype.itemsize * d * shard_len  # per window
    starts = _shard_bounds(num_rows, window_rows, shard_len, d)
    candidates: list[CodecPlan] = []

    def rle_plan(max_runs: int) -> CodecPlan:
        # Observed max + slack for the padding run and the clip boundary.
        return CodecPlan(kind="rle", dtype=block_dtype.str, d=d, shard_len=shard_len,
                         runs_cap=bucket_cap(min(max_runs + 2, shard_len)))

    def rle_too_dear(changes: int) -> bool:
        return rle_plan(changes + 1).wire_nbytes() * min_ratio > block_bytes

    first_span = arr.size - 1
    if starts.size > 1:
        first_span = int(min(starts[1], arr.size - 2))
    if arr.size <= 1 or not _changes_exceed(arr, first_span, rle_too_dear):
        rle = rle_plan(_max_runs_per_shard(arr, starts))
        if rle.wire_nbytes() * min_ratio <= block_bytes:
            candidates.append(rle)
    # The widest delta range whose encoding would pay (wire bytes grow with
    # the delta width, so the paying widths are a prefix).
    paying = [
        rng for rng, ddt in ((0xF, "nib"), (0xFF, np.dtype(np.uint8).str),
                             (0xFFFF, np.dtype(np.uint16).str))
        if CodecPlan(kind="delta", dtype=block_dtype.str, d=d, shard_len=shard_len,
                     delta_dtype=ddt).wire_nbytes() * min_ratio <= block_bytes
    ]
    if paying and affine and arr.dtype.kind in "iu" and arr.size > 1:
        lo, hi = _delta_range(arr, stop_above=paying[-1])
        ddt = _delta_dtype_for(hi - lo) if hi - lo <= paying[-1] else None
        if ddt is not None:
            delta = CodecPlan(kind="delta", dtype=block_dtype.str, d=d,
                              shard_len=shard_len, delta_dtype=ddt, delta_off=lo)
            if delta.wire_nbytes() * min_ratio <= block_bytes:
                candidates.append(delta)
    if not candidates:
        return None
    return min(candidates, key=lambda p: p.wire_nbytes())


def plan_codec_local(
    packed: np.ndarray, d: int, nblk: int, b: int, rows: int, min_ratio: float
) -> Optional[CodecPlan]:
    """Single-window plan from the PACKED (transformed, padded) flat array:
    the monolithic staging's entry point."""
    shard_len = nblk * b
    return plan_codec(
        packed[: max(rows, 1)], packed.dtype, d, nblk, b,
        window_rows=d * shard_len, num_rows=max(rows, 1), min_ratio=min_ratio,
        affine=packed.dtype.kind in "iu",
    )


# -- host encode -------------------------------------------------------------


def encode_window(packed_flat: np.ndarray, plan: CodecPlan, rows: int) -> CodecPayload:
    """Encode one window's packed flat array ([d * shard_len], zeros past
    ``rows``) into its payload. Raises CodecOverflow when the window defeats
    the plan: the caller ships that window raw."""
    d, L = plan.d, plan.shard_len
    shards = packed_flat.reshape(d, L)
    if plan.kind == "rle":
        values = np.zeros((d, plan.runs_cap), dtype=packed_flat.dtype)
        ends = np.full((d, plan.runs_cap), L, dtype=np.int32)
        for s in range(d):
            v = shards[s]
            bitsv = _bits(v)
            chg = np.flatnonzero(bitsv[1:] != bitsv[:-1]) + 1
            if chg.size + 1 > plan.runs_cap:
                raise CodecOverflow(f"{chg.size + 1} runs > cap {plan.runs_cap}")
            starts = np.concatenate(([0], chg))
            values[s, : starts.size] = v[starts]
            ends[s, : starts.size] = np.append(chg, L).astype(np.int32)
        return CodecPayload(plan, (values, ends))
    nib = plan.delta_dtype == "nib"
    ddt = np.dtype(np.uint8) if nib else np.dtype(plan.delta_dtype)
    dmax = 0xF if nib else (1 << (8 * ddt.itemsize)) - 1
    bases = np.zeros(d, np.int64)
    rows_v = np.clip(rows - np.arange(d) * L, 0, L).astype(np.int32)
    deltas = np.zeros((d, L), dtype=ddt)
    for s in range(d):
        r = int(rows_v[s])
        if r == 0:
            continue
        v = shards[s][:r].astype(np.int64)
        bases[s] = v[0]
        if r > 1:
            enc = np.diff(v) - plan.delta_off
            if enc.size and (int(enc.min()) < 0 or int(enc.max()) > dmax):
                raise CodecOverflow("delta outside planned range")
            deltas[s, 1:r] = enc.astype(ddt)
    if nib:
        # Two 4-bit deltas a byte, the even index in the low nibble.
        half = (L + 1) // 2
        if L % 2:
            deltas = np.concatenate([deltas, np.zeros((d, 1), np.uint8)], axis=1)
        deltas = (deltas[:, 0::2] | (deltas[:, 1::2] << 4))[:, :half]
    return CodecPayload(plan, (bases, deltas, rows_v))


# -- device decode -----------------------------------------------------------


def rle_decode_plain(values: torch.Tensor, ends: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of H18: ``out`` [d, L] (any 1-, 2-, 4- or 8-byte dtype,
    that of ``values`` [d, R]) gets values[min(searchsorted(ends, i, right),
    R - 1)] for every row i, as bits. ``ends`` is int32 [d, R]."""
    d, R = values.shape
    L = out.shape[-1]
    iota = torch.arange(L, dtype=torch.int32, device=ends.device).expand(d, L).contiguous()
    j = torch.clamp_max(torch.searchsorted(ends, iota, right=True), R - 1)
    view = _INT_VIEW[values.element_size()]
    out.view(view).copy_(torch.gather(values.view(view), 1, j))
    return out


def delta_decode_plain(
    bases: torch.Tensor, deltas: torch.Tensor, rows: torch.Tensor, off: int,
    nib: bool, out: torch.Tensor,
) -> torch.Tensor:
    """Plain version of H19: ``out`` [d, L] (an integer dtype) gets
    base + inclusive_cumsum(d64) at the rows below ``rows`` and 0 past them,
    where d64 = delta + off, zeroed at row 0 and past ``rows``; the int64
    sums wrap mod 2^64 and the cast keeps the low bits, as astype does.
    ``deltas`` is [d, L] (any integer dtype) or, with ``nib``, uint8
    [d, ceil(L / 2)] with the even row in the low nibble."""
    d, L = out.shape
    if nib:
        dl = torch.stack([deltas & 0xF, deltas >> 4], dim=-1).reshape(d, -1)[:, :L]
    else:
        dl = deltas
    iota = torch.arange(L, dtype=torch.int64, device=out.device)
    r = rows.to(torch.int64)[:, None]
    d64 = torch.where((iota > 0) & (iota < r), dl.to(torch.int64) + off, 0)
    v = torch.where(iota < r, bases[:, None] + torch.cumsum(d64, dim=1), 0)
    if out.dtype == torch.uint16:  # torch has no int64 -> uint16 arithmetic path
        v = (v & 0xFFFF).to(torch.int32)
    elif out.dtype == torch.uint8:
        v = v & 0xFF
    out.copy_(v.to(out.dtype))
    return out


def decode(arrays: list, plan: CodecPlan, out: torch.Tensor) -> torch.Tensor:
    """Expand one window's payload (its ``arrays`` as tensors on the device)
    into ``out`` ([d, shard_len] of the plan's dtype, or a view of that
    shape): H18 or H19 on CUDA, the plain versions on the CPU."""
    if plan.kind == "rle":
        values, ends = arrays
        if out.is_cuda:
            return kernels.codec_rle_decode(values, ends, out)
        return rle_decode_plain(values, ends, out)
    bases, deltas, rows = arrays
    nib = plan.delta_dtype == "nib"
    if out.is_cuda:
        return kernels.codec_delta_decode(bases, deltas, rows, plan.delta_off, nib, out)
    return delta_decode_plain(bases, deltas, rows, plan.delta_off, nib, out)


# -- raw -> plan converters (device-resident ingest) -------------------------

def _wrap_to(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An integer tensor cast to an integer or bool ``dtype`` keeping the
    low bytes, as numpy's astype wraps (torch has no int64 -> uint16 path:
    it goes through int32)."""
    if dtype == torch.bool:
        return v != 0
    if dtype == torch.uint16:
        return (v.to(torch.int64) & 0xFFFF).to(torch.int32).to(torch.uint16)
    if dtype == torch.uint8:
        return (v.to(torch.int64) & 0xFF).to(torch.uint8)
    return v.to(dtype)


def convert_block_plain(col_plan, raw_block: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of H24: ``out`` (the plan's dtype, the shape of
    ``raw_block``; a strided view such as a window's slice of a staging of
    D shards is written in place) gets ``raw_block`` converted per
    ``col_plan``:
    ("raw", _) a cast, ("narrow", (dt, off)) ``(x.astype(int64) - off)
    .astype(dt)``, ("f32", _) ``x.astype(float32)``, ("intdict", (lut, dt))
    ``min(searchsorted(lut, x), C - 1).astype(dt)``; integers wrap to their
    low bytes."""
    kind, info = col_plan
    x = raw_block
    if kind in ("raw", "f32") and (x.dtype.is_floating_point or out.dtype.is_floating_point):
        # f64 -> f32 as numpy's astype: round to nearest even, overflow to
        # inf, subnormals kept, a NaN's sign and top payload bits kept.
        v = x.to(out.dtype)
    elif kind == "raw":
        v = _wrap_to(x, out.dtype)
    elif kind == "narrow":
        v = _wrap_to(x.to(torch.int64) - int(info[1]), out.dtype)
    elif kind == "intdict":
        lut = torch.as_tensor(np.asarray(info[0], np.int64), device=x.device)
        c = torch.searchsorted(lut, x.to(torch.int64).reshape(-1)).clamp_max(lut.numel() - 1)
        v = _wrap_to(c.reshape(x.shape), out.dtype)
    else:
        raise ValueError(f"unknown col plan kind {kind!r}")
    out.copy_(v.reshape(out.shape))
    return out


def convert_block(col_plan, raw_block: torch.Tensor, out: Optional[torch.Tensor] = None,
                  int_dtype=None) -> torch.Tensor:
    """Apply a StreamPlan col_plan ("raw" / "narrow" / "f32" / "intdict") to
    a raw-dtype resident block ([D, nblk, b]: a ring window's D shards on
    one device), returning the plan-dtype block the fold reads. ``out`` (the
    window's slice of the stream's preallocated staging, ``[:, lo:hi]``: D
    runs at the staging's shard stride) receives it with no further
    allocation, in one launch;
    ``int_dtype`` is the plan's block dtype of a "raw" column. The narrow
    offset and the LUT are the whole column's (``plan_stream``). H24 on
    CUDA tensors, ``convert_block_plain`` on CPU tensors."""
    kind, info = col_plan
    if kind == "raw":
        dst = raw_block.dtype if int_dtype is None else TORCH_DTYPES[np.dtype(int_dtype)]
    elif kind == "f32":
        dst = torch.float32
    elif kind == "narrow":
        dst = TORCH_DTYPES[np.dtype(info[0])]
    elif kind == "intdict":
        dst = TORCH_DTYPES[np.dtype(info[1])]
    else:
        raise ValueError(f"unknown col plan kind {kind!r}")
    if out is None:
        out = torch.empty(raw_block.shape, dtype=dst, device=raw_block.device)
    elif out.dtype != dst or out.shape != raw_block.shape:
        raise ValueError(
            f"convert_block: out is {out.dtype} {tuple(out.shape)}, the plan needs {dst} "
            f"{tuple(raw_block.shape)}"
        )
    if not raw_block.is_cuda:
        return convert_block_plain(col_plan, raw_block, out)
    if kind == "intdict":
        lut = torch.as_tensor(np.asarray(info[0], np.int64), device=raw_block.device)
        return kernels.ring_convert(raw_block, out, "intdict", lut=lut)
    off = int(info[1]) if kind == "narrow" else 0
    return kernels.ring_convert(raw_block, out, kind, off=off)
