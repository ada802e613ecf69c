"""Static-shape merging t-digest, vectorized over groups
(pixie_tpu/ops/tdigest.py).

A digest is a [num_groups, capacity] pair of float32 (means, weights). A
block of rows is sorted by (group, value), each row gets its rank in its
group, its k1-scale cluster id from the rank's mid-quantile, and the rows of
each (group, cluster) are summed into a batch digest, which is merged into
the state: concatenate, stable-sort each group's centroids by mean (empty
ones last), and recompress by the cluster ids of the cumulative weights'
midpoints.

On CUDA tensors ``update`` runs H7 (up to 254 groups: the block's
per-cluster sums without a sort, from each group's keys selected at the
ranks where the cluster changes) and H8 (the merge); above 254 groups H7a
(pack each row's sort key, count rows per group), ``torch.sort`` of the
keys and H7b (rank, cluster and per-cluster sums over the sorted keys)
take H7's place. ``merge`` is H8 and ``quantile_values`` H9. On CPU
tensors the plain versions below run.

The arithmetic of ranks, mid-quantiles and cluster ids is the reference's
float32 arithmetic, step by step. Its ``arcsin`` is not: XLA-CPU, PyTorch
and CUDA's ``asinf`` differ by an ulp or two, so a cluster id may differ by
one where the float64 coordinate k(q) * capacity lies within 1e-4 of an
integer (the Fault-4 contract, PERF.md). The plain version takes the
float64 asin rounded to float32, the same on every CPU and in every process.
Sums of the rows of a cluster are taken in float64 and rounded to float32
once (the reference adds in float32).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from pixie_tpu_torch.ops import kernels

DEFAULT_CAPACITY = 256
# The packed-key sort applies while the group id plus its sentinel fits in
# this many key bits; as many low bits of the value's order-preserving key
# are dropped (the reference's _PACK_MAX_GROUP_BITS).
_PACK_MAX_GROUP_BITS = 8
M32 = 0xFFFFFFFF

_F32 = torch.float32


def init(num_groups: int, device, capacity: int = DEFAULT_CAPACITY) -> dict:
    return {
        "means": torch.zeros((num_groups, capacity), dtype=_F32, device=device),
        "weights": torch.zeros((num_groups, capacity), dtype=_F32, device=device),
    }


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32, device=device)


def _k_scale(q: torch.Tensor) -> torch.Tensor:
    """The k1 scale function normalized to [0, 1], in float32."""
    dev = q.device
    q = torch.minimum(torch.maximum(q, _f32(1e-7, dev)), _f32(1 - 1e-7, dev))
    x = _f32(2.0, dev) * q - _f32(1.0, dev)
    a = torch.asin(x.to(torch.float64)).to(_F32)
    return a / _f32(math.pi, dev) + _f32(0.5, dev)


def _cluster_ids(q: torch.Tensor, capacity: int) -> torch.Tensor:
    k = torch.floor(_k_scale(q) * _f32(float(capacity), q.device))
    return torch.clamp(k.to(torch.int32), 0, capacity - 1)


def _order_key(v32: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32): the order-preserving u32 map of float32 bits
    (negatives flipped, the sign bit set on the rest)."""
    u = v32.view(torch.int32).to(torch.int64) & M32
    return torch.where((u >> 31) > 0, (~u) & M32, u | 0x80000000)


def _from_order_key(mapped: torch.Tensor) -> torch.Tensor:
    u = torch.where((mapped >> 31) > 0, mapped & 0x7FFFFFFF, (~mapped) & M32)
    return u.to(torch.int32).view(_F32)


def _sorted_rows(gids, v32, mask, num_groups: int):
    """(sorted gids, sorted values): masked rows and gids outside [0, G)
    sort to the sentinel group G. Up to 255 groups the sort key is the
    reference's packed u32 (group in the top ``bits_g`` bits, the value's
    order key less its ``bits_g`` low bits, values rebuilt from the key);
    above, (group, order key) as an int64, values untruncated."""
    ok = (gids >= 0) & (gids < num_groups)
    if mask is not None:
        ok = ok & mask
    g = torch.where(ok, gids.to(torch.int64), num_groups)
    bits_g = max((num_groups + 1).bit_length(), 1)
    mapped = _order_key(v32)
    if bits_g <= _PACK_MAX_GROUP_BITS:
        ks = torch.sort((g << (32 - bits_g)) | (mapped >> bits_g)).values
        return ks >> (32 - bits_g), _from_order_key((ks << bits_g) & M32)
    ks = torch.sort((g << 32) | mapped).values
    return ks >> 32, _from_order_key(ks & M32)


def _row_clusters(g_s, num_groups: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat cell, mid-quantile) of each sorted row: its rank in its group,
    qmid = (rank + 0.5) / count in f32, and cell g * C + cluster id (G * C
    for the sentinel rows)."""
    qs = torch.arange(num_groups + 1, dtype=g_s.dtype, device=g_s.device)
    starts = torch.searchsorted(g_s, qs, side="left")
    counts = torch.searchsorted(g_s, qs, side="right") - starts
    gc = torch.clamp_max(g_s, num_groups)
    rank = (torch.arange(g_s.shape[0], device=g_s.device) - starts[gc]).to(torch.int32).to(_F32)
    cnt = counts[gc].to(torch.int32).to(_F32)
    qmid = (rank + _f32(0.5, rank.device)) / torch.clamp_min(cnt, 1.0)
    flat = torch.where(
        g_s < num_groups, g_s * capacity + _cluster_ids(qmid, capacity), num_groups * capacity
    )
    return flat, qmid


def _cluster_sums_plain(g_s, v_s, num_groups: int, capacity: int) -> torch.Tensor:
    """Plain version of H7b: float64 [2, G, C] row counts and value sums of
    each (group, cluster) over the sorted rows."""
    flat, _ = _row_clusters(g_s, num_groups, capacity)
    live = g_s < num_groups
    sums = torch.zeros((2, num_groups * capacity + 1), dtype=torch.float64, device=g_s.device)
    sums[0].index_add_(0, flat, live.to(torch.float64))
    sums[1].index_add_(0, flat, torch.where(live, v_s, 0.0).to(torch.float64))
    return sums[:, :-1].reshape(2, num_groups, capacity)


def update_plain(state: dict, gids, values, mask: Optional[torch.Tensor] = None) -> dict:
    """Plain version of H7a + sort + H7b + H8."""
    num_groups, capacity = state["means"].shape
    g_s, v_s = _sorted_rows(gids, values.to(_F32), mask, num_groups)
    sums = _cluster_sums_plain(g_s, v_s, num_groups, capacity)
    return merge_plain(state, batch_from_sums(sums[0], sums[1]))


def batch_from_sums(w_sum: torch.Tensor, v_sum: torch.Tensor) -> dict:
    """The batch digest of per-(group, cluster) float64 weight and value
    sums: both rounded to float32, mean = sum / max(weight, 1) (H8 builds
    it the same way from H7b's sums)."""
    w = w_sum.to(_F32)
    m = v_sum.to(_F32)
    return {"means": torch.where(w > 0, m / torch.clamp_min(w, 1.0), 0.0), "weights": w}


def update(state: dict, gids, values, mask: Optional[torch.Tensor] = None) -> dict:
    """Fold a block of (group, value) rows into the digests."""
    if not state["means"].is_cuda:
        return update_plain(state, gids, values, mask)
    num_groups, capacity = state["means"].shape
    gids = gids.to(torch.int32).contiguous()
    if num_groups <= kernels.TD_UPDATE_MAX_G:
        if values.dtype not in (torch.float32, torch.float64):
            values = values.to(_F32)
        sums = kernels.tdigest_update_sums(values.contiguous(), gids, mask, num_groups, capacity)
    else:
        keys, counts = kernels.tdigest_pack(values.to(_F32).contiguous(), gids, mask, num_groups)
        # A library sort, as the reference's jnp.sort, of int64 (group << 32
        # | order key) keys.
        keys = torch.sort(keys).values
        sums = kernels.tdigest_cluster(keys, counts, num_groups, capacity)
    return kernels.tdigest_merge(
        state["means"], state["weights"], sums[0], sums[1], raw_b=True
    )


def merge_plain(a: dict, b: dict) -> dict:
    """Plain version of H8."""
    num_groups, capacity = a["means"].shape
    means = torch.cat([a["means"], b["means"]], dim=1)
    weights = torch.cat([a["weights"], b["weights"]], dim=1)
    key = torch.where(weights > 0, means, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)
    means = torch.gather(means, 1, order)
    weights = torch.gather(weights, 1, order)
    total = weights.sum(dim=1, keepdim=True)
    cum = torch.cumsum(weights, dim=1)
    qmid = (cum - _f32(0.5, cum.device) * weights) / torch.clamp_min(total, 1.0)
    cl = _cluster_ids(qmid, capacity)
    g = torch.arange(num_groups, dtype=torch.int64, device=cl.device)[:, None]
    flat = (g * capacity + cl).reshape(-1)
    nseg = num_groups * capacity
    w_new = torch.zeros(nseg, dtype=_F32, device=cl.device).index_add_(
        0, flat, weights.reshape(-1)
    )
    m_sum = torch.zeros(nseg, dtype=_F32, device=cl.device).index_add_(
        0, flat, (means * weights).reshape(-1)
    )
    w_new = w_new.reshape(num_groups, capacity)
    m_sum = m_sum.reshape(num_groups, capacity)
    return {
        "means": torch.where(w_new > 0, m_sum / torch.clamp_min(w_new, 1e-9), 0.0),
        "weights": w_new,
    }


def merge(a: dict, b: dict) -> dict:
    if a["means"].is_cuda:
        return kernels.tdigest_merge(a["means"], a["weights"], b["means"], b["weights"])
    return merge_plain(a, b)


def quantile_values_plain(state: dict, qs: Sequence[float]) -> torch.Tensor:
    """Plain version of H9: float64 [num_groups, len(qs)] by interpolation
    between the centroids around each target rank, every f32 step rounded
    on its own (as the reference's standalone quantile_values computes)."""
    means, weights = state["means"], state["weights"]
    total = weights.sum(dim=1, keepdim=True)
    cum = torch.cumsum(weights, dim=1) - _f32(0.5, weights.device) * weights
    target = torch.as_tensor(qs, dtype=_F32, device=means.device)[None, :] * total
    reached = (cum[:, :, None] >= target[:, None, :]) & (weights > 0)[:, :, None]
    idx_hi = torch.argmax(reached.to(torch.uint8), dim=1)  # first True
    last_valid = torch.clamp_min((weights > 0).sum(dim=1) - 1, 0)
    idx_hi = torch.where(reached.any(dim=1), idx_hi, last_valid[:, None])
    idx_lo = torch.clamp_min(idx_hi - 1, 0)
    m_lo, m_hi = torch.gather(means, 1, idx_lo), torch.gather(means, 1, idx_hi)
    c_lo, c_hi = torch.gather(cum, 1, idx_lo), torch.gather(cum, 1, idx_hi)
    frac = torch.where(
        c_hi > c_lo,
        (target - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-9),
        1.0,
    )
    frac = torch.clamp(frac, 0.0, 1.0)
    out = m_lo + frac * (m_hi - m_lo)
    out = torch.where(idx_hi == idx_lo, m_hi, out)
    return torch.where(total > 0, out, 0.0).to(torch.float64)


def quantile_exact_groups(weights: torch.Tensor) -> torch.Tensor:
    """bool [num_groups]: the groups whose weights are whole numbers in
    [0, 2^24] with a total of at most 2^24. Every partial sum of such a
    group is exact in any order, so H9's quantiles of it are the plain
    version's bits; every digest a path makes has whole weights (they count
    rows)."""
    whole = (weights >= 0) & (weights <= 2.0**24) & (weights == torch.trunc(weights))
    total = torch.where(whole, weights, 0.0).to(torch.float64).sum(dim=1)
    return whole.all(dim=1) & (total <= 2.0**24)


def quantile_values(state: dict, qs: Sequence[float]) -> torch.Tensor:
    if state["means"].is_cuda:
        return kernels.tdigest_quantiles(
            state["means"].contiguous(), state["weights"].contiguous(),
            torch.as_tensor(qs, dtype=_F32, device=state["means"].device),
        )
    return quantile_values_plain(state, qs)
