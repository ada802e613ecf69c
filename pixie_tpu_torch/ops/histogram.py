"""Log-binned per-group histogram sketch (DDSketch-style).

State is int64 [num_groups, nbins]; bins are logarithmic with ratio gamma:
bin(v) = floor(log(v / min) / log(gamma)) + 1 in f32, values <= min land in
bin 0 and the last bin catches the tail (pixie_tpu/ops/histogram.py).

On a CUDA tensor ``update`` launches H3 and ``quantile_values`` H4
(ops/kernels); on a CPU tensor the plain PyTorch versions below run. The f32
log differs between XLA, PyTorch's CPU and CUDA's ``logf`` by an ulp now and
then, which moves a value lying within ~2.5e-4 of a bin edge by one bin;
PERF.md states that contract and tests/test_torch_histogram.py holds it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from pixie_tpu_torch.ops import kernels


@dataclasses.dataclass(frozen=True)
class LogHistogramSpec:
    nbins: int = 1024
    min_value: float = 1.0  # ns granularity for latency telemetry
    max_value: float = 1e12

    @property
    def gamma(self) -> float:
        return math.exp(math.log(self.max_value / self.min_value) / (self.nbins - 2))

    @property
    def relative_error(self) -> float:
        g = self.gamma
        return (g - 1) / (g + 1)


DEFAULT_SPEC = LogHistogramSpec()


def init(num_groups: int, device, spec: LogHistogramSpec = DEFAULT_SPEC) -> torch.Tensor:
    return torch.zeros((num_groups, spec.nbins), dtype=torch.int64, device=device)


def bin_index(values: torch.Tensor, spec: LogHistogramSpec = DEFAULT_SPEC) -> torch.Tensor:
    """int32 log bin of each value, computed in f32 as the reference does.

    The f32 log is the f64 log rounded to f32: PyTorch's CPU f32 log is
    not the same function from one process to the next (its vectorized
    and scalar paths differ by more than an ulp), so it could break the
    Fault-1 contract now and then; the rounded f64 log is within half an
    ulp every time."""
    vf = values.to(torch.float32)
    min_v = torch.tensor(spec.min_value, dtype=torch.float32, device=vf.device)
    log_gamma = torch.tensor(math.log(spec.gamma), dtype=torch.float32, device=vf.device)
    v = torch.maximum(vf, min_v)
    log_v = torch.log((v / min_v).to(torch.float64)).to(torch.float32)
    x = torch.floor(log_v / log_gamma)
    # XLA's f32 -> int32 convert maps NaN to 0 and saturates +inf to
    # INT32_MAX, whose +1 wraps to INT32_MIN and clips to bin 0; torch's
    # cast leaves both to the platform, so they are spelled out here.
    x = torch.where(torch.isnan(x), 0.0, torch.where(torch.isinf(x), -1.0, x))
    idx = x.to(torch.int32) + 1
    idx = torch.where(vf <= min_v, 0, idx)
    return torch.clamp(idx, 0, spec.nbins - 1)


def update_plain(
    state: torch.Tensor, gids: torch.Tensor, values: torch.Tensor,
    mask: Optional[torch.Tensor] = None, spec: LogHistogramSpec = DEFAULT_SPEC,
) -> torch.Tensor:
    """Plain version of H3: adds the (group, bin) counts into ``state`` in
    place and returns it."""
    num_groups, nbins = state.shape
    ok = (gids >= 0) & (gids < num_groups)
    if mask is not None:
        ok = ok & mask
    flat = gids.to(torch.int64) * nbins + bin_index(values, spec).to(torch.int64)
    state.view(-1).index_add_(0, flat[ok], torch.ones_like(flat[ok]))
    return state


def update(
    state: torch.Tensor, gids: torch.Tensor, values: torch.Tensor,
    mask: Optional[torch.Tensor] = None, spec: LogHistogramSpec = DEFAULT_SPEC,
) -> torch.Tensor:
    """Count each valid row into its (group, log bin) cell, in place."""
    if state.is_cuda:
        # H3 reads f32 or f64 values as staged (f64 rounded to f32 in
        # registers); any other dtype is converted here.
        if values.dtype not in (torch.float32, torch.float64):
            values = values.to(torch.float32)
        return kernels.log_histogram_update(
            values.contiguous(),
            gids.to(torch.int32).contiguous(),
            mask,
            state,
            spec.min_value,
            math.log(spec.gamma),
        )
    return update_plain(state, gids, values, mask, spec)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def _bin_values(bins: torch.Tensor, spec: LogHistogramSpec) -> torch.Tensor:
    """f64 value of each bin index: its geometric midpoint
    min * gamma^(bin - 1) * sqrt(gamma), bin 0 the minimum."""
    g = torch.tensor(spec.gamma, dtype=torch.float64, device=bins.device)
    vals = spec.min_value * torch.pow(
        g, torch.clamp_min(bins - 1, 0).to(torch.float64)
    ) * math.sqrt(spec.gamma)
    return torch.where(bins == 0, spec.min_value, vals)


def quantile_values_plain(
    state: torch.Tensor, qs: Sequence[float], spec: LogHistogramSpec = DEFAULT_SPEC
) -> torch.Tensor:
    """Plain version of H4: [num_groups, len(qs)] float64 — per group and q,
    the geometric midpoint of the first bin whose cumulative count reaches
    q * total (the DDSketch estimator)."""
    counts = state.to(torch.float64)
    total = counts.sum(dim=1, keepdim=True)
    cum = torch.cumsum(counts, dim=1)
    qs_t = torch.as_tensor(qs, dtype=torch.float64, device=state.device)
    target = torch.clamp_min(qs_t[None, :] * total, 1e-9)  # [G, Q]
    reached = cum[:, :, None] >= target[:, None, :]  # [G, B, Q]
    # first True along the bins (0 where none is, like argmax)
    bin_idx = torch.argmax(reached.to(torch.uint8), dim=1)
    return torch.where(total > 0, _bin_values(bin_idx, spec), 0.0)


_MIDPOINTS: dict = {}


def midpoint_table(spec: LogHistogramSpec, device) -> torch.Tensor:
    """f64 [nbins]: each bin's value as ``quantile_values_plain`` computes it
    on ``device`` (the same expression), built once per (spec, device). H4
    reads a quantile's value from it and so returns the plain version's
    bits."""
    device = torch.device(device)
    key = (spec, device)
    table = _MIDPOINTS.get(key)
    if table is None:
        table = _bin_values(torch.arange(spec.nbins, dtype=torch.int64, device=device), spec)
        _MIDPOINTS[key] = table
    return table


def quantile_values(
    state: torch.Tensor, qs: Sequence[float], spec: LogHistogramSpec = DEFAULT_SPEC
) -> torch.Tensor:
    if state.is_cuda:
        return kernels.hist_quantiles(
            state.contiguous(),
            torch.as_tensor(qs, dtype=torch.float64, device=state.device),
            midpoint_table(spec, state.device),
        )
    return quantile_values_plain(state, qs, spec)
