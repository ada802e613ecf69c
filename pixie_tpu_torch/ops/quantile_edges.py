"""The quantile finalizes' (H4's and H9's) edge states: the inputs on which
the card tests (tests/test_torch_kernels.py), the CPU tests
(tests/test_torch_histogram.py, tests/test_torch_sketches.py),
chip_smoke.py and tools/h4_h9_phases.py hold ``kernels.hist_quantiles``
against ``histogram.quantile_values_plain`` and ``kernels.tdigest_quantiles``
against ``tdigest.quantile_values_plain``.

Log histograms (int64 [S, nbins]): an empty group, everything in bin 0, a
single non-empty bin, one count in the last bin, counts near 2^40 in every
bin, ones in every bin and a sparse row, the rest random counts over the
upper two thirds of the bins; at the spec's 1024 bins, at widths inside one
warp's chunk of 1024 (even, odd) and past it. Digests (f32 [G, C] means and
weights): an empty group, one centroid, empty centroids between full ones,
all weight in the last centroid, most of it there after small ones, a
weight of 2^24 - C + 1 beside ones (a total of exactly 2^24), the rest full
digests of whole weights; groups that H9 sums in centroid order (a total
above 2^24, fractional weights) are flagged by
``tdigest.quantile_exact_groups``; at the paths' capacity 256 and at
capacities that are not a multiple of 256. Two computations of such a
group's quantiles round its cumulative weights in their own orders, so
they agree only within ``td_inexact_tol``.
"""

from __future__ import annotations

import numpy as np
import torch

QS = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)  # the UDAs' QUANTILE_QS
QS_WIDE = tuple(float(q) for q in np.linspace(0.0, 1.0, 40))  # past a warp's 32 qs

# nbins: the spec's, inside one chunk of 1024 (even and 16-byte rows, odd),
# just past one chunk (odd), three chunks.
HIST_NBINS = (1024, 100, 999, 1025, 3000)
# C: the paths' 256, inside one chunk of 256 (16-byte vectors, scalar loads),
# past one chunk (vectors, scalar).
TD_CAPACITIES = (256, 100, 37, 300, 513)
HIST_EDGE_GROUPS = 7  # the edge rows at the top of hist_edge_state's
TD_EDGE_GROUPS = 9  # the edge groups at the top of td_edge_state's


def hist_edge_state(nbins: int, S: int, seed: int) -> np.ndarray:
    """int64 [S, nbins], S > HIST_EDGE_GROUPS: group 0 empty; 1 everything
    in bin 0; 2 a single non-empty bin (the middle one); 3 one count in the
    last bin; 4 counts near 2^40 in every bin; 5 ones in every bin; 6 every
    97th bin; the rest random counts below 2^20 over the upper two thirds
    of the bins."""
    if S <= HIST_EDGE_GROUPS:
        raise ValueError(f"hist_edge_state: S must exceed {HIST_EDGE_GROUPS}, got {S}")
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 1 << 20, (S, nbins)).astype(np.int64)
    state[:, : nbins // 3] = 0
    state[:HIST_EDGE_GROUPS] = 0
    state[1, 0] = 5
    state[2, nbins // 2] = 12345
    state[3, nbins - 1] = 1
    state[4] = (1 << 40) - rng.integers(0, 1 << 20, nbins)
    state[5] = 1
    state[6, ::97] = rng.integers(1, 1000, len(range(0, nbins, 97)))
    return state


def td_edge_state(C: int, G: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(means, weights), f32 [G, C], G > TD_EDGE_GROUPS + 1, as update and
    merge leave digests (empty centroids mean 0 and weight 0; the live ones'
    means ascend): group 0 empty; 1 one centroid; 2 live centroids with
    empty ones between; 3 all weight in the last centroid; 4 small
    centroids, then most of the weight in the last; 5 a weight of
    2^24 - C + 1 and ones (a total of 2^24, still exact); 6 a total above
    2^24 (whole weights); 7 fractional weights; 8 one centroid of weight
    2^24 + 2 (above the exact range); the rest full digests of whole weights
    below 2^24 / C."""
    if G <= TD_EDGE_GROUPS + 1:
        raise ValueError(f"td_edge_state: G must exceed {TD_EDGE_GROUPS + 1}, got {G}")
    rng = np.random.default_rng(seed)
    means = np.sort(rng.exponential(3e7, (G, C)), axis=1).astype(np.float32)
    weights = rng.integers(1, max(2, (1 << 24) // C), (G, C)).astype(np.float32)
    weights[:TD_EDGE_GROUPS] = 0
    weights[1, 0] = 7
    weights[2, ::5] = rng.integers(1, 5000, len(range(0, C, 5)))
    weights[3, C - 1] = 1000
    weights[4, : C // 2] = 1
    weights[4, C - 1] = 100 * C
    weights[5] = 1
    weights[5, C // 3] = (1 << 24) - C + 1
    weights[6] = (1 << 25) // C + 3
    weights[7] = rng.random(C).astype(np.float32) * 100
    weights[8, C // 2] = (1 << 24) + 2
    means[weights == 0] = 0
    return means, weights


def td_inexact_tol(means: torch.Tensor, weights: torch.Tensor, qs) -> torch.Tensor:
    """f64 [G, Q]: the bound within which two computations of each quantile
    of a digest whose cumulative weights round (a total above 2^24,
    fractional weights) agree, value by value.

    Each computation sums the weights in its own order (the reference's f32
    cumsum, torch's CPU or CUDA scan, H9's centroid order). A sum of n
    non-zero terms (zeros add exactly) is within n 2^-24 of its size in any
    order, so the target q * total is within n_tot 2^-24 t of the exact t,
    and a bracket's midpoints through centroid j within (n_j + 1) 2^-24
    run_j (n_j the non-empty centroids through j, run_j their weight). Each
    computation then places the target in bracket j within
    W_j = 4 2^-24 (n_tot t + (n_j + 1) run_j) of where the exact sums would
    (a margin of two on the two computations' errors); with one non-empty
    centroid every sum is exact and W_j = 0. The bound is the
    range of the reference's interpolation, taken exactly in f64, over the
    targets within W_j of t in every bracket j that this window touches (at
    both ends of its part of the window: the interpolation is linear within
    a bracket and may jump between two), plus 4 f32 ulps of the largest
    mean it touches for the interpolation's own rounding. A low quantile is
    held as tightly as a high one."""
    w = weights.to(torch.float64)
    m = means.to(torch.float64)
    G, C = w.shape
    q = torch.as_tensor(qs, dtype=torch.float32, device=w.device).to(torch.float64)
    run = torch.cumsum(w, dim=1)
    mid = run - 0.5 * w
    valid = w > 0
    nz = torch.cumsum(valid, dim=1).to(torch.float64)
    keyed = torch.cummax(torch.where(valid, mid, -torch.inf), dim=1).values
    inf = torch.full((G, 1), torch.inf, dtype=w.dtype, device=w.device)
    # brackets: j < C a non-empty centroid j, the targets above the last
    # non-empty midpoint before it up to its own; j = C the targets above
    # every non-empty midpoint, which the reference sends to the count of
    # non-empty centroids less one (last_valid), whatever centroid that is
    hi = torch.cat([torch.arange(C, device=w.device).expand(G, C),
                    torch.clamp_min(nz[:, -1:].long() - 1, 0)], dim=1)  # [G, C + 1]
    lo = torch.clamp_min(hi - 1, 0)
    live = torch.cat([valid, nz[:, -1:] > 0], dim=1)
    start = torch.cat([-inf, keyed], dim=1)
    end = torch.cat([mid, inf], dim=1)
    n_run = torch.cat([(nz + 1) * run, (nz[:, -1:] + 1) * run[:, -1:]], dim=1)
    c_lo, c_hi = (torch.gather(mid, 1, i)[:, None, :] for i in (lo, hi))  # [G, 1, C + 1]
    m_lo, m_hi = (torch.gather(m, 1, i)[:, None, :] for i in (lo, hi))
    t = (q[None, :] * run[:, -1:])[:, :, None]  # [G, Q, 1]
    # [G, Q, C + 1]; 0 for one non-empty centroid: every sum is then exact
    # and both computations round the same operands once, alike
    win = torch.where(nz[:, -1:, None] > 1,
                      4 * 2.0**-24 * (nz[:, -1:, None] * t + n_run[:, None, :]), 0.0)
    a = torch.maximum(t - win, start[:, None, :])
    b = torch.minimum(t + win, end[:, None, :])
    touched = live[:, None, :] & (a <= b) & (start[:, None, :] < t + win)

    def value(x: torch.Tensor) -> torch.Tensor:
        frac = torch.where(c_hi > c_lo,
                           (x - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-9), 1.0).clamp(0.0, 1.0)
        return torch.where((hi == lo)[:, None, :], m_hi, m_lo + frac * (m_hi - m_lo))

    va, vb = value(a), value(b)
    top = torch.where(touched, torch.maximum(va, vb), -torch.inf).amax(dim=2)
    bottom = torch.where(touched, torch.minimum(va, vb), torch.inf).amin(dim=2)
    size = torch.where(touched, torch.maximum(m_lo.abs(), m_hi.abs()), 0.0).amax(dim=2)
    return torch.where(touched.any(dim=2), top - bottom + 4 * 2.0**-23 * size, 0.0)
