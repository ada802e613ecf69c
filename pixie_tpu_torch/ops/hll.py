"""HyperLogLog distinct-count sketch, vectorized over groups
(pixie_tpu/ops/hll.py).

State is int32 [num_groups, m] registers (m = 2^precision); each row's u32
hash gives a register (its top ``precision`` bits) and a rho (leading zeros
of the rest, plus one), and each register keeps its largest rho. Merge is an
elementwise max.

On a CUDA tensor ``update`` launches H5 (hash, register, rho and an atomic
max in one pass over the block, IN PLACE; a ``segment.Narrow`` column read
as staged), ``cell_update`` H20 (the
int-dictionary cell lane: one update per (group, value code) cell present in
a histogram, IN PLACE) and ``estimate`` H10; on a CPU tensor the plain
versions below run. The reference's sort-compact lane and its scatter-max
give the same registers.
"""

from __future__ import annotations

from typing import Optional

import torch

from pixie_tpu_torch.ops import hashing, kernels, segment

DEFAULT_PRECISION = 11  # m = 2048 registers -> ~2.3% standard error


def init(num_groups: int, device, precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    if precision < 4:
        raise ValueError(f"HLL precision must be >= 4 (got {precision})")
    return torch.zeros((num_groups, 1 << precision), dtype=torch.int32, device=device)


def _precision(m: int) -> int:
    return int(m).bit_length() - 1


def _reg_rho(values: torch.Tensor, precision: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(register index, rho) of each value, int32 (plain; H5 computes them
    in its pass)."""
    h = hashing.hash32_plain(values)
    reg = h >> (32 - precision)
    rest = (h << precision) & hashing.M32
    rho = torch.clamp_max(hashing.clz32(rest) + 1, 32 - precision + 1)
    return reg.to(torch.int32), rho.to(torch.int32)


def update_plain(
    state: torch.Tensor, gids: torch.Tensor, values: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of H5: the new registers (the reference's scatter-max
    lane)."""
    num_groups, m = state.shape
    reg, rho = _reg_rho(values, _precision(m))
    if mask is not None:
        rho = torch.where(mask, rho, 0)
    flat = segment.flat_segment_ids(gids, reg, m)
    maxes = torch.zeros(num_groups * m, dtype=rho.dtype, device=rho.device)
    segment.segment_minmax_plain(maxes, rho, flat, None, is_min=False)
    return torch.maximum(state, maxes.reshape(num_groups, m))


def update(
    state: torch.Tensor, gids: torch.Tensor, values,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fold a block of (group, value) rows into the registers; on CUDA the
    registers are updated in place. ``values`` is a column or a
    ``segment.Narrow`` (a narrowed int64 column: each row hashes as its
    int64 value, which H5 forms from the staged bytes and the offset)."""
    if state.is_cuda:
        if isinstance(values, segment.Narrow):
            col, off = values.values, values.offset
        else:
            col, off = values, None
        return kernels.hll_update(
            col.contiguous(), gids.to(torch.int32).contiguous(), mask, state, off,
        )
    return update_plain(state, gids, segment.widen(values), mask)


def cell_update_plain(state: torch.Tensor, hist: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain version of H20: the new registers. Every row of a cell carries
    the same (register, rho), so the max of rho over the PRESENT cells
    (hist > 0) is the row path's register (pixie_tpu/ops/hll.py:82)."""
    num_groups, m = state.shape
    reg, rho = _reg_rho(lut, _precision(m))  # [C] each
    rho_gc = torch.where(hist > 0, rho[None, :], 0).to(torch.int32)
    flat = (
        torch.arange(num_groups, dtype=torch.int32, device=state.device)[:, None] * m
        + reg[None, :]
    ).reshape(-1)
    maxes = torch.zeros(num_groups * m, dtype=torch.int32, device=state.device)
    segment.segment_minmax_plain(maxes, rho_gc.reshape(-1), flat, None, is_min=False)
    return torch.maximum(state, maxes.reshape(num_groups, m))


def cell_update(state: torch.Tensor, hist: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Fold a per-(group, value code) histogram (int64 [G, C]; ``lut`` [C]
    the int64 value of each code) into the registers; on CUDA in place."""
    if state.is_cuda:
        return kernels.hll_cell_update(state, hist.contiguous(), lut.contiguous())
    return cell_update_plain(state, hist, lut)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def estimate_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain version of H10: float64 [num_groups] estimates with the
    linear-counting (small range) and 2^32 (large range) corrections. The
    raw estimate is alpha m^2 over the sum in one IEEE division, as the
    reference's and H10's (a Python float over a tensor would be torch's
    reciprocal times the float, an ulp off that quotient)."""
    _, m = state.shape
    regs = state.to(torch.float64)
    sums = torch.sum(torch.pow(2.0, -regs), dim=1)
    raw = torch.full_like(sums, _alpha(m) * m * m) / sums
    zeros = torch.sum(state == 0, dim=1).to(torch.float64)
    linear = m * torch.log(torch.clamp_min(m / torch.clamp_min(zeros, 1e-9), 1.0))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    two32 = float(1 << 32)
    large = -two32 * torch.log(
        torch.clamp_min(1.0 - torch.clamp_max(raw, two32 * 0.9999) / two32, 1e-12)
    )
    corrected = torch.where(raw > two32 / 30.0, large, raw)
    return torch.where(use_linear, linear, corrected)


def estimate(state: torch.Tensor) -> torch.Tensor:
    """float64 [num_groups] cardinality estimates."""
    if state.is_cuda:
        return kernels.hll_estimate(state.contiguous(), _alpha(state.shape[1]))[0]
    return estimate_plain(state)


def estimate_rounded(state: torch.Tensor) -> torch.Tensor:
    """int64 [num_groups]: the estimates rounded half to even, as the UDA's
    finalize (``jnp.round``) does. H10 on CUDA writes both in one launch."""
    if state.is_cuda:
        return kernels.hll_estimate(state.contiguous(), _alpha(state.shape[1]))[1]
    return torch.round(estimate_plain(state)).to(torch.int64)

