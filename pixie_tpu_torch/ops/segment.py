"""Masked segment reductions — the group-by aggregation primitive.

Group keys are dense int32 segment ids (gids); padding and filtered rows carry
mask=False, and a gid outside [0, num_segments) contributes nothing, as in
the reference (pixie_tpu/ops/segment.py), whose one-hot einsums and 8-bit
limbs exist only to keep the TPU's slow scatter unit off the hot path.

Each function takes its device from its tensors: on a CUDA tensor it
launches the hand kernel of ``ops/kernels`` (H1 for integer sums and counts,
H2 for f64 sums), on a CPU tensor it runs the plain PyTorch version beside
it. The plain versions are the ones the CPU tests hold against the
reference, and chip_smoke.py holds the kernels against them on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pixie_tpu_torch.ops import kernels


def _valid(seg_ids: torch.Tensor, num_segments: int, mask: Optional[torch.Tensor]):
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    if mask is not None:
        ok = ok & mask
    return ok, torch.where(ok, seg_ids, 0).to(torch.int64)


def segment_rows_sum_i64_plain(
    rows: torch.Tensor, seg_ids: torch.Tensor, mask: Optional[torch.Tensor],
    num_segments: int,
) -> torch.Tensor:
    """Plain version of H1: int64 [R + 1, S], the last row the count of
    valid rows. int64 adds wrap, so sums are exact mod 2^64."""
    ok, idx = _valid(seg_ids, num_segments, mask)
    R = rows.shape[0]
    out = torch.zeros((R + 1, num_segments), dtype=torch.int64, device=rows.device)
    if R:
        out[:R].index_add_(1, idx, torch.where(ok, rows, 0))
    out[R].index_add_(0, idx, ok.to(torch.int64))
    return out


def seg_count_plain(
    seg_ids: torch.Tensor, num_segments: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain int64 [S] count of valid rows per segment, on any device."""
    empty = torch.empty((0, seg_ids.shape[0]), dtype=torch.int64, device=seg_ids.device)
    return segment_rows_sum_i64_plain(empty, seg_ids, mask, num_segments)[0]


def segment_sum_f64_plain(
    values: torch.Tensor, seg_ids: torch.Tensor, mask: Optional[torch.Tensor],
    num_segments: int,
) -> torch.Tensor:
    """Plain version of H2: f64 [S] sums of the valid rows."""
    ok, idx = _valid(seg_ids, num_segments, mask)
    out = torch.zeros(num_segments, dtype=torch.float64, device=values.device)
    return out.index_add_(0, idx, torch.where(ok, values, 0.0))


def segment_rows_sum_i64(
    rows: torch.Tensor, seg_ids: torch.Tensor, mask: Optional[torch.Tensor],
    num_segments: int,
) -> torch.Tensor:
    """int64 [R + 1, S]: per-segment sums of R int64 rows (mod 2^64), then
    the per-segment count of valid rows. H1 on CUDA."""
    seg_ids = seg_ids.to(torch.int32)
    if seg_ids.is_cuda:
        return kernels.segment_rows_sum_i64(
            rows.contiguous(), seg_ids.contiguous(), mask, num_segments
        )
    return segment_rows_sum_i64_plain(rows, seg_ids, mask, num_segments)


def fused_segment_sums(
    rows: Sequence[torch.Tensor], seg_ids: torch.Tensor,
    num_segments: int, mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused-sum lane: every int64 row of the sum-family UDAs plus the
    presence row in one reduction, int64 [len(rows) + 1, S]. Counterpart of
    the reference's limb_einsum_sums + reconstruct_i64 over limb rows."""
    n = seg_ids.shape[0]
    stacked = (
        torch.stack([r.to(torch.int64) for r in rows])
        if rows
        else torch.empty((0, n), dtype=torch.int64, device=seg_ids.device)
    )
    return segment_rows_sum_i64(stacked, seg_ids, mask, num_segments)


def seg_count(
    seg_ids: torch.Tensor, num_segments: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """int64 [S] count of valid rows per segment."""
    return fused_segment_sums([], seg_ids, num_segments, mask)[0]


def seg_sum(
    values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment sum of int64 (exact mod 2^64, H1) or float64 (H2)
    values; other dtypes are not on the port's path and raise."""
    if values.dtype == torch.int64:
        return fused_segment_sums([values], seg_ids, num_segments, mask)[0]
    if values.dtype != torch.float64:
        raise TypeError(f"seg_sum takes int64 or float64 values, not {values.dtype}")
    seg_ids = seg_ids.to(torch.int32)
    if seg_ids.is_cuda:
        return kernels.segment_sum_f64(
            values.contiguous(), seg_ids.contiguous(), mask, num_segments
        )
    return segment_sum_f64_plain(values, seg_ids, mask, num_segments)


def seg_max(
    values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment max; empty segments hold the dtype's smallest value, as
    the reference's ``jax.ops.segment_max`` gives. A plain version only: the
    port's one caller on the card, the HLL register update, is the fused
    kernel H5 (ops/hll.py)."""
    ok, idx = _valid(seg_ids, num_segments, mask)
    if values.is_floating_point():
        fill = float("-inf")
    else:
        fill = torch.iinfo(values.dtype).min
    out = torch.full((num_segments,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, idx[ok], values[ok], "amax", include_self=True)


def flat_segment_ids(
    gids: torch.Tensor, inner_ids: torch.Tensor, inner_size: int
) -> torch.Tensor:
    """(group, bucket) -> flat segment id gids * inner_size + inner, int32."""
    return gids.to(torch.int32) * inner_size + inner_ids.to(torch.int32)
