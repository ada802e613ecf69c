"""ML runtime ops: priority reservoirs and k-means (ref: pixie_tpu/ops/ml.py).

A reservoir keeps, per group, the k rows of highest deterministic hash
priority: each row's priority mixes the hash of its value bits with the hash
of its position in the block plus a salt (the rows the state has counted so
far), so a reservoir depends on the block geometry, the masks and the order
of the blocks exactly as the reference's does. Merge is concat + top-k,
associative and static-shape. k-means is Lloyd's over [G, S, d] sample
tensors at finalize time.

On a CUDA tensor the priorities are H25 (``reservoir_priority``) and the
per-group top-k of an update or a merge is H26: for an update of few groups
(``kernels.topk_rows_fits``) over the rows in row order
(``reservoir_topk_rows``), else after a stable sort of the gids buckets the
rows by group (``reservoir_topk``, one CTA a group); k-means is H27
(``kmeans_fit``); on a CPU tensor the plain versions below run, which repeat
the reference's sorts step for step. ``kmeans_assign`` is numpy on the host
in both packages.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pixie_tpu_torch.ops import hashing, kernels

DEFAULT_RESERVOIR = 64
TWO53 = float(1 << 53)


# -- priority reservoir ---------------------------------------------------------
def reservoir_init(num_groups: int, device, k: int = DEFAULT_RESERVOIR,
                   dtype=torch.float64) -> dict:
    """Empty reservoirs: values of the argument's dtype (int64 samples
    round-trip beyond 2^53), priorities -inf, counts 0."""
    return {
        "values": torch.zeros((num_groups, k), dtype=dtype, device=device),
        "priority": torch.full((num_groups, k), -torch.inf, dtype=torch.float64, device=device),
        "count": torch.zeros(num_groups, dtype=torch.int64, device=device),
    }


def priorities_plain(values: torch.Tensor, salt, mask=None) -> torch.Tensor:
    """Plain version of H25 (the reference's ``_priorities`` with the
    update's mask applied), on any device: row i's priority is
    combine(hash64(value), hash64(i + salt)) >> 11, / 2^53; -inf where
    ``mask`` is False. ``salt`` is an int or an int64 tensor of one value."""
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=values.device) + salt
    h = hashing.combine(hashing.hash64(values), hashing.hash64(idx))
    pri = hashing.srl64(h, 11).to(torch.float64) / TWO53
    if mask is not None:
        pri = torch.where(mask, pri, torch.full_like(pri, -torch.inf))
    return pri


def priorities(values: torch.Tensor, salt, mask=None) -> torch.Tensor:
    """Each row's priority: H25 on a CUDA tensor, else the plain version."""
    if not values.is_cuda:
        return priorities_plain(values, salt, mask)
    salt_t = torch.as_tensor(salt, dtype=torch.int64, device=values.device).reshape(1)
    return kernels.reservoir_priority(
        hashing.words_u64(values).contiguous(), mask, salt_t.contiguous()
    )


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64) if x.dtype == torch.float64 else x


def reservoir_update(state: dict, gids: torch.Tensor, values: torch.Tensor, mask=None) -> dict:
    """Fold a block into per-group top-k-by-priority reservoirs. The salt is
    the state's count sum: the rows masked in before this block."""
    if values.is_cuda:
        return _update_kernel(state, gids, values, mask)
    return update_plain(state, gids, values, mask)


def update_plain(state: dict, gids: torch.Tensor, values: torch.Tensor, mask=None) -> dict:
    """Plain version of ``reservoir_update``: the priorities, then
    ``topk_rows_plain``."""
    G = state["values"].shape[0]
    v = values.to(state["values"].dtype)
    if mask is None:
        mask = torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
    pri = priorities_plain(v, state["count"].sum(), mask)
    return topk_rows_plain(state, torch.where(mask, gids.to(torch.int64), G), pri, v)


def topk_rows_plain(state: dict, g: torch.Tensor, pri: torch.Tensor, v: torch.Tensor) -> dict:
    """Plain version of H26 for an update, on any device, as the reference
    computes it: rank the rows by (group, -priority) with a stable sort,
    scatter each group's top k into a candidate reservoir, merge. ``g`` is
    each row's group, G for a row that is not a candidate."""
    G, k = state["values"].shape
    n = v.shape[0]
    dev = v.device
    # The stable sort by (g, -pri): by -pri, then by g.
    o1 = torch.sort(-pri, stable=True).indices
    order = o1[torch.sort(g[o1], stable=True).indices]
    g_s, p_s, v_s = g[order], pri[order], v[order]
    counts = torch.bincount(g_s, minlength=G + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[g_s]
    keep = (g_s < G) & (rank < k)
    slot = torch.where(keep, g_s * k + rank, G * k)
    cand_v = torch.zeros(G * k + 1, dtype=v.dtype, device=dev)
    cand_p = torch.full((G * k + 1,), -torch.inf, dtype=torch.float64, device=dev)
    cand_v[slot[keep]] = v_s[keep]
    cand_p[slot[keep]] = p_s[keep]
    cand = {
        "values": cand_v[:-1].reshape(G, k),
        "priority": cand_p[:-1].reshape(G, k),
        "count": counts[:-1],
    }
    return reservoir_merge_plain(state, cand)


def bucket_rows(g: torch.Tensor, G: int) -> tuple:
    """(order, offsets): the rows of group j are order[offsets[j]:offsets[j +
    1]] in row order (a stable sort of the gids, each group's bounds found
    in the sorted gids); rows of group G (not candidates) sort last. The
    gids sort as int32 (half the radix passes of int64)."""
    g = g.to(torch.int32)
    g_sorted, order = torch.sort(g, stable=True)
    offsets = torch.searchsorted(g_sorted, torch.arange(G + 1, dtype=g.dtype, device=g.device))
    return order, offsets


def _update_kernel(state: dict, gids: torch.Tensor, values: torch.Tensor, mask) -> dict:
    """H25 for the priorities, then H26 for each group's top k: over the
    rows in row order when every group's k fit one CTA
    (``kernels.topk_rows_fits``: no bucketing), else after a stable sort of
    the gids buckets the rows by group (masked rows to bucket G)."""
    G, k = state["values"].shape
    v = values.to(state["values"].dtype).contiguous()
    salt = state["count"].sum().reshape(1)
    pri = kernels.reservoir_priority(hashing.words_u64(v).contiguous(), mask, salt)
    g = gids.to(torch.int32)
    if mask is not None:
        g = torch.where(mask, g, G)
    st_vals, st_pri = _bits(state["values"]).contiguous(), state["priority"].contiguous()
    if kernels.topk_rows_fits(G, k):
        vals, pris, count = kernels.reservoir_topk_rows(
            st_vals, st_pri, state["count"].contiguous(), _bits(v), pri, g.contiguous())
    else:
        order, offsets = bucket_rows(g, G)
        vals, pris = kernels.reservoir_topk(st_vals, st_pri, _bits(v), pri, order, offsets)
        count = state["count"] + torch.diff(offsets)
    return {"values": vals.view(state["values"].dtype), "priority": pris, "count": count}


def topk_by_priority_plain(vals_a, vals_b, pri_a, pri_b, k: int):
    """Plain per-group top-k over concatenated candidates (a stable argsort
    of the negated priorities: ties keep a's slots first). vals may carry
    trailing dims ([G, S] or [G, S, d]); priorities are [G, S]."""
    vals = torch.cat([vals_a, vals_b], dim=1)
    pris = torch.cat([pri_a, pri_b], dim=1)
    order = torch.sort(-pris, dim=1, stable=True).indices[:, :k]
    vorder = order.reshape(order.shape + (1,) * (vals.dim() - 2)).expand(
        order.shape + vals.shape[2:]
    )
    return torch.gather(vals, 1, vorder), torch.gather(pris, 1, order)


def topk_by_priority(vals_a, vals_b, pri_a, pri_b, k: int):
    """Per-group top-k over concatenated candidates: on the card H26 (for
    [G, k] values against [G, k] values), else the plain version."""
    if not pri_a.is_cuda:
        return topk_by_priority_plain(vals_a, vals_b, pri_a, pri_b, k)
    G, ka = pri_a.shape
    if vals_a.dim() != 2 or ka != k or pri_b.shape[0] != G:
        raise ValueError("topk_by_priority: on the card only [G, k] reservoirs merge (H26)")
    kb = pri_b.shape[1]
    offsets = torch.arange(G + 1, dtype=torch.int64, device=pri_a.device) * kb
    order = torch.arange(G * kb, dtype=torch.int64, device=pri_a.device)
    vals, pris = kernels.reservoir_topk(
        _bits(vals_a).contiguous(), pri_a.contiguous(),
        _bits(vals_b).contiguous().reshape(-1), pri_b.contiguous().reshape(-1), order, offsets,
    )
    return vals.view(vals_a.dtype), pris


def reservoir_merge(a: dict, b: dict) -> dict:
    """Concat candidates and keep the top k priorities per group (H26 on the
    card)."""
    k = a["values"].shape[1]
    vals, pris = topk_by_priority(a["values"], b["values"], a["priority"], b["priority"], k)
    return {"values": vals, "priority": pris, "count": a["count"] + b["count"]}


def reservoir_merge_plain(a: dict, b: dict) -> dict:
    """Plain version of ``reservoir_merge``, on any device."""
    k = a["values"].shape[1]
    vals, pris = topk_by_priority_plain(
        a["values"], b["values"], a["priority"], b["priority"], k
    )
    return {"values": vals, "priority": pris, "count": a["count"] + b["count"]}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def reservoir_finalize(state) -> np.ndarray:
    """[G] JSON strings {"count": N, "sample": [...]} of the live slots (host;
    NaN and +-inf stay in the state but not in the JSON)."""
    vals = _host(state["values"])
    pris = _host(state["priority"])
    counts = _host(state["count"])
    is_int = np.issubdtype(vals.dtype, np.integer)
    out = np.empty(vals.shape[0], dtype=object)
    for gid in range(vals.shape[0]):
        live = vals[gid][np.isfinite(pris[gid])]
        if not is_int:
            live = live[np.isfinite(live)]
        sample = [int(x) if is_int else float(x) for x in live]
        out[gid] = json.dumps({"count": int(counts[gid]), "sample": sample})
    return out


# -- k-means ----------------------------------------------------------------------
def kmeans_fit_plain(points: torch.Tensor, weights: torch.Tensor, k: int,
                     iters: int = 10) -> torch.Tensor:
    """Plain version of H27 on any device: points f32 [G, S, d], weights
    [G, S] (0 = empty slot) -> centers [G, k, d]. Farthest-point seeding from
    the first live point, then Lloyd; empty clusters stay on their seed."""
    G, S, d = points.shape
    dev = points.device
    live = weights > 0
    first = torch.argmax(live.to(torch.int32), dim=1)
    ar = torch.arange(G, device=dev)
    centers = torch.zeros((G, k, d), dtype=points.dtype, device=dev)
    centers[:, 0] = points[ar, first]

    def d2(c):
        return ((points[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)  # [G, S, k]

    neg_inf = torch.tensor(-torch.inf, dtype=points.dtype, device=dev)
    for i in range(1, min(k, S)):
        mind = d2(centers[:, :i]).amin(dim=2)
        mind = torch.where(live, mind, neg_inf)
        nxt = torch.argmax(mind, dim=1)
        centers[:, i] = points[ar, nxt]
    for _ in range(iters):
        assign = torch.argmin(d2(centers), dim=2)  # [G, S]
        onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype) * weights[:, :, None]
        sums = torch.bmm(onehot.transpose(1, 2), points)  # [G, k, d]
        wsum = onehot.sum(dim=1)  # [G, k]
        centers = torch.where(
            (wsum > 0)[:, :, None], sums / torch.clamp(wsum, min=1e-9)[:, :, None], centers
        )
    return centers


def kmeans_fit(points: torch.Tensor, weights: torch.Tensor, k: int, iters: int = 10):
    """Centers [G, k, d] of each group's weighted points [G, S, d] (a [S, d]
    input gives [k, d]): H27 on the card, else the plain version."""
    single = points.dim() == 2
    if single:
        points, weights = points[None], weights[None]
    points = points.to(torch.float32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    if points.is_cuda:
        out = kernels.kmeans_fit(points, weights, int(k), int(iters))
    else:
        out = kmeans_fit_plain(points, weights, int(k), int(iters))
    return out[0] if single else out


def kmeans_assign(point: np.ndarray, centers: np.ndarray) -> int:
    """Nearest-center index for one point [d] against centers [k, d] (host)."""
    return int(np.argmin(np.sum((centers - point[None, :]) ** 2, axis=1)))
