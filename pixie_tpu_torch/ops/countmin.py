"""Count-min frequency sketch, vectorized over groups
(pixie_tpu/ops/countmin.py).

State is int64 [num_groups, depth, width]. Each row adds one to ``depth``
buckets of its group, bucket_d = (h1 + d * h2) & (width - 1) from the two
u32 hashes of ``hashing.hash32_pair(value, seed=1)`` (Kirsch-Mitzenmacher
double hashing). Merge is an elementwise add; ``query`` takes the min over
the depth rows.

On a CUDA tensor ``update_counted`` launches H6, which reads the column as
staged, hashes each word itself and adds each group's row count into the
UDA's ``total`` in the same pass; on a CPU tensor the plain versions below
run.
``cell_update_counted`` is the int-dictionary cell lane: one update per
(group, value code) cell of a histogram, which gives the row path's cells;
on CUDA one H21 launch updates the sketch and ``total`` in place. ``query``
launches H30 on CUDA (no path calls it in either package yet).
"""

from __future__ import annotations

from typing import Optional

import torch

from pixie_tpu_torch.ops import hashing, kernels, segment

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 8192  # eps ~ e / width ~ 3.3e-4 of the total count


def init(
    num_groups: int, device, depth: int = DEFAULT_DEPTH, width: int = DEFAULT_WIDTH
) -> torch.Tensor:
    if width & (width - 1):
        raise ValueError(
            f"count-min width must be a power of two (got {width}): "
            "bucketing masks with width-1"
        )
    return torch.zeros((num_groups, depth, width), dtype=torch.int64, device=device)


def _buckets(values: torch.Tensor, depth: int, width: int) -> list:
    """The ``depth`` int32 bucket indices of each value (plain; H6 hashes
    in the kernel)."""
    h1, h2 = hashing.hash32_pair_plain(values, seed=1)
    return [((h1 + d * h2) & (width - 1)).to(torch.int32) for d in range(depth)]


def update_plain(
    state: torch.Tensor, gids: torch.Tensor, values: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of H6's sketch update: the new counts."""
    num_groups, depth, width = state.shape
    outs = [
        segment.seg_count_plain(
            segment.flat_segment_ids(gids, b, width), num_groups * width, mask
        ).reshape(num_groups, width)
        for b in _buckets(values, depth, width)
    ]
    return state + torch.stack(outs, dim=1)


def update_counted(
    state: torch.Tensor, total: torch.Tensor, gids: torch.Tensor,
    values, mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts, total): the sketch updated with a block of rows and each
    group's count of valid rows added to ``total`` (int64 [num_groups]).
    ``values`` is a column or a ``segment.Narrow`` (a narrowed int64 column:
    each row hashes as its int64 value, which H6 forms from the staged bytes
    and the offset). On CUDA both are updated in place by one H6 launch,
    which hashes the words itself."""
    if state.is_cuda:
        if isinstance(values, segment.Narrow):
            col, off = values.values, values.offset
        else:
            col, off = values, None
        kernels.countmin_update(
            col.contiguous(), gids.to(torch.int32).contiguous(), mask, state, total, off
        )
        return state, total
    values = segment.widen(values)
    counts = update_plain(state, gids, values, mask)
    return counts, total + segment.seg_count_plain(gids, total.shape[0], mask)


def update(
    state: torch.Tensor, gids: torch.Tensor, values: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference's ``update``: the sketch alone."""
    if state.is_cuda:
        scratch = torch.zeros(state.shape[0], dtype=torch.int64, device=state.device)
        return update_counted(state, scratch, gids, values, mask)[0]
    return update_plain(state, gids, values, mask)


def cell_update_plain(state: torch.Tensor, hist: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain version of H21's sketch update: the new counts. Every row of a
    cell hashes alike, so adding the cell's COUNT to its value's buckets is
    the row path's update (pixie_tpu/ops/countmin.py:82)."""
    num_groups, depth, width = state.shape
    C = lut.shape[0]
    cg = torch.arange(num_groups * C, dtype=torch.int64, device=state.device) // C
    counts = hist.reshape(-1).to(torch.int64)
    outs = []
    for b in _buckets(lut, depth, width):
        flat = cg * width + b.to(torch.int64).repeat(num_groups)
        outs.append(
            torch.zeros(num_groups * width, dtype=torch.int64, device=state.device)
            .index_add_(0, flat, counts)
            .reshape(num_groups, width)
        )
    return state + torch.stack(outs, dim=1)


def cell_update_counted(
    state: torch.Tensor, total: torch.Tensor, hist: torch.Tensor, lut: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts, total): the sketch updated with a per-(group, value code)
    histogram (int64 [G, C]; ``lut`` [C] the int64 value of each code) and
    each group's row count added to ``total``. On CUDA both are updated in
    place by one H21 launch."""
    if state.is_cuda:
        kernels.countmin_cell_update(state, total, hist.contiguous(), lut.contiguous())
        return state, total
    return cell_update_plain(state, hist, lut), total + hist.sum(dim=1)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def query(state: torch.Tensor, gids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Estimated counts of (group, value) pairs: the min over depth rows.
    One H30 launch on CUDA (gids in [0, num_groups))."""
    if state.is_cuda:
        return kernels.countmin_query(
            state.contiguous(), gids.to(torch.int32).contiguous(),
            hashing.words64(values).contiguous(),
        )
    return query_plain(state, gids, values)


def query_plain(state: torch.Tensor, gids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Plain version of H30."""
    _, depth, width = state.shape
    g = gids.to(torch.int64)
    ests = [state[g, d, b.to(torch.int64)] for d, b in enumerate(_buckets(values, depth, width))]
    return torch.min(torch.stack(ests, dim=0), dim=0).values
