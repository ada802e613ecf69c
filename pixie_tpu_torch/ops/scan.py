"""The device scan's stable compaction.

Counterpart of the body of the ``while_loop`` in the reference's
``_build_scan_program`` (pixie_tpu/parallel/pipeline.py:4149-4190): per
block, the executor (``DeviceExecutor._run_scan``) ANDs the predicates into
the validity mask and evaluates the output expressions; here the selected
rows are appended, in row order, to the output buffers at ``written``, then
``written = min(written + count, limit)``. The reference compacts with a
stable sort keyed on ``~mask`` and a dynamic_update_slice of the whole
sorted block; here the compaction is the kernel H12 on CUDA
(ops/kernels/scan_kernels.cu) and ``compact_rows_plain`` on the CPU. Both
keep ``written`` on the tensor's device, and neither writes a row at or past
``limit``, so the output buffers need only ``limit`` rows.

``compact_indices`` is the same compaction over the row indices themselves
(H12's index lane), padded with the row count: the join's unmatched rows
(``segment.compact_unmatched_rows``).
"""

from __future__ import annotations

import torch

from pixie_tpu_torch.ops import kernels


def compact_rows_plain(
    mask: torch.Tensor, cols: list, written: torch.Tensor, bufs: list, limit: int
) -> None:
    """Plain version of H12: the rows whose ``mask`` is true, in row order,
    go to ``bufs[c][written:]`` up to ``limit``; ``written`` (int32 [1])
    becomes min(written + count, limit)."""
    w = int(written[0])
    if w >= limit:
        return
    idx = torch.nonzero(mask).flatten()
    take = min(idx.numel(), limit - w)
    for c, buf in zip(cols, bufs):
        buf[w : w + take] = c[idx[:take]]
    written.fill_(min(w + idx.numel(), limit))


def compact_rows(
    mask: torch.Tensor, cols: list, written: torch.Tensor, bufs: list, limit: int
) -> None:
    """H12 on CUDA, ``compact_rows_plain`` on the CPU."""
    if mask.is_cuda:
        kernels.scan_compact(mask, cols, written, bufs, limit)
    else:
        compact_rows_plain(mask, cols, written, bufs, limit)



def compact_indices_plain(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of H12's index lane: the indices of the rows whose
    ``mask`` is true, in row order, int32 [cap], and the row count in every
    slot past theirs."""
    n = mask.shape[0]
    out = torch.full((cap,), n, dtype=torch.int32, device=mask.device)
    idx = torch.nonzero(mask).flatten()[:cap]
    out[: idx.numel()] = idx.to(torch.int32)
    return out


def compact_indices(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """H12's index lane on CUDA, ``compact_indices_plain`` on the CPU."""
    if mask.is_cuda:
        return kernels.scan_compact_indices(mask, cap)
    return compact_indices_plain(mask, cap)
