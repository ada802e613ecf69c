"""Masked segment reductions — the group-by aggregation primitive.

Group keys are dense int32 segment ids (gids); padding and filtered rows carry
mask=False, and a gid outside [0, num_segments) contributes nothing, as in
the reference (pixie_tpu/ops/segment.py), whose one-hot einsums and 8-bit
limbs exist only to keep the TPU's slow scatter unit off the hot path.

Each function takes its device from its tensors: on a CUDA tensor it
launches the hand kernel of ``ops/kernels`` (H1 for integer sums and counts,
its rows read as the fold staged them: ``Narrow``, ``PRESENCE``; H2 for f64
sums, ``F64Row``s of f64 or integer columns summed or squared; H11 for min
and max, a ``Narrow`` read as staged too; H13-H15 and H12 for the
sort-merge join's primitives, H16 for the join-aggregate lane's
weighted fold at the end), on a CPU tensor it runs the plain PyTorch
version beside it. The plain versions are the ones the CPU tests
hold against the reference, and chip_smoke.py holds the kernels against
them on the card.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import torch

from pixie_tpu_torch.ops import kernels, scan

# Which device lanes ran, by name, since the last reduce_lanes(reset=True).
# The reference counts a lane once per compiled program; the port builds no
# programs, so it counts each run of the lane (``join_sort_merge``: once per
# device join; ``join_agg``: once per join-aggregate query; ``fold_key_host``,
# ``fold_key_lut``, ``fold_key_codes`` or ``fold_key_none``: once per device
# fold, by how its gids materialize; ``arghash``: once per fold that gathers
# a string-hash argument through its content-hash LUT).
LANE_COUNTS: dict[str, int] = {}
_LANE_LOCK = threading.Lock()  # concurrent queries count from their threads


def lane_count(name: str) -> None:
    with _LANE_LOCK:
        LANE_COUNTS[name] = LANE_COUNTS.get(name, 0) + 1


def reduce_lanes(reset: bool = False) -> dict:
    with _LANE_LOCK:
        snap = dict(LANE_COUNTS)
        if reset:
            LANE_COUNTS.clear()
    return snap


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


class Narrow(NamedTuple):
    """A column as the fold staged it: row i's int64 value is
    ``values[i] + offset`` (wrapping), ``values`` uint8, uint16 or int32
    (frame-of-reference narrowing, ``staging._narrow_int``)."""

    values: torch.Tensor
    offset: int


# The presence row of the fused-sum lane: count's row, the count of valid
# rows itself (H1 reads no bytes for it).
PRESENCE = None


def widen(col):
    """The int64 column of a ``Narrow`` (any other column as it is)."""
    if isinstance(col, Narrow):
        return col.values.to(torch.int64) + col.offset
    return col


def _plain_row(row, mask: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    if row is PRESENCE:
        if mask is None:
            return torch.ones(n, dtype=torch.int64, device=device)
        return mask.to(torch.int64)
    return widen(row).to(torch.int64)


def fused_segment_sums(
    rows: Sequence, seg_ids: torch.Tensor,
    num_segments: int, mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused-sum lane: every row of the sum-family UDAs plus the
    presence row in one reduction, int64 [len(rows) + 1, S] (sums mod 2^64,
    the count last). A row is an integer or bool tensor, a ``Narrow`` or
    ``PRESENCE``; H1 reads each where it lies, the plain version widens
    them. Counterpart of the reference's limb_einsum_sums + reconstruct_i64
    over limb rows."""
    seg_ids = seg_ids.to(torch.int32)
    if seg_ids.is_cuda:
        pairs = []
        for row in rows:
            if row is PRESENCE:
                pairs.append((None, 0))
            elif isinstance(row, Narrow):
                pairs.append((row.values.contiguous(), row.offset))
            elif row.dtype in kernels.SUM_ROW_KINDS:
                pairs.append((row.contiguous(), 0))
            else:
                pairs.append((row.to(torch.int64).contiguous(), 0))
        return kernels.segment_rows_sum_i64(pairs, seg_ids.contiguous(), mask, num_segments)
    return fused_segment_sums_plain(rows, seg_ids, num_segments, mask)


def fused_segment_sums_plain(
    rows: Sequence, seg_ids: torch.Tensor,
    num_segments: int, mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the fused-sum lane, on any device: every row
    widened to int64 and stacked, then H1's plain version."""
    n, device = seg_ids.shape[0], seg_ids.device
    stacked = (
        torch.stack([_plain_row(r, mask, n, device) for r in rows])
        if rows
        else torch.empty((0, n), dtype=torch.int64, device=device)
    )
    return segment_rows_sum_i64_plain(stacked, seg_ids, mask, num_segments)


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
    return f64_segment_sums([F64Row(values)], seg_ids, num_segments, mask)[0]


class F64Row(NamedTuple):
    """A row of the f64 lane (H2): ``values`` an f64 column, or an integer
    or bool column (or a ``Narrow``) whose values are rounded to f64, summed
    as they are or, with ``square``, each value's square (rounded on its
    own) summed."""

    values: object
    square: bool = False

    def key(self) -> tuple:
        """Rows of equal keys (on one device) sum the same values: one view
        of one storage (and offset), one op."""
        col, off = (self.values.values, self.values.offset) \
            if isinstance(self.values, Narrow) else (self.values, 0)
        return col.data_ptr(), col.dtype, col.shape, col.stride(), off, self.square


def _f64_row_values(row: F64Row) -> torch.Tensor:
    x = widen(row.values).to(torch.float64)
    return x * x if row.square else x


def segment_rows_sum_f64_plain(
    rows: Sequence[F64Row], seg_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of H2: f64 [R, S], each row widened to f64 (and
    squared), then H2's single-row plain version."""
    out = torch.zeros((len(rows), num_segments), dtype=torch.float64, device=seg_ids.device)
    for r, row in enumerate(rows):
        out[r] = segment_sum_f64_plain(_f64_row_values(row), seg_ids, mask, num_segments)
    return out


def f64_segment_sums(
    rows: Sequence[F64Row], seg_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The f64 lane: f64 [len(rows), S] per-segment sums of ``F64Row``s in
    one reduction (H2 reads each row where it lies: f64, or an integer row
    widened in registers, a ``Narrow`` with its offset). Counterpart of the
    reference's seg_sum over f64 values, one call a row."""
    seg_ids = seg_ids.to(torch.int32)
    if not seg_ids.is_cuda:
        return segment_rows_sum_f64_plain(rows, seg_ids, num_segments, mask)
    triples = []
    for row in rows:
        col, off = (row.values.values, row.values.offset) if isinstance(row.values, Narrow) \
            else (row.values, 0)
        if col.dtype not in kernels.H2_KINDS:
            col = col.to(torch.float64)
        triples.append((col.contiguous(), off, row.square))
    return kernels.segment_rows_sum_f64(triples, seg_ids.contiguous(), mask, num_segments)


def _identity_for(dtype: torch.dtype, is_min: bool):
    """The min/max identity of ``dtype`` that empty segments hold: +-inf for
    floats, the integer type's max (min) or min (max)."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


_F64_LOW63 = 0x7FFFFFFFFFFFFFFF
_CANONICAL_NAN = 0x7FF8000000000000


def _f64_keys(values: torch.Tensor, is_min: bool) -> torch.Tensor:
    """H11's order-preserving int64 key of each f64: a non-negative bit
    pattern is its own key, a negative one has its low 63 bits flipped (so
    -0.0 sorts just below +0.0), and every NaN takes the key that wins."""
    bits = values.view(torch.int64)
    keys = torch.where(bits >= 0, bits, bits ^ _F64_LOW63)
    nan_key = torch.iinfo(torch.int64).min if is_min else torch.iinfo(torch.int64).max
    return torch.where(torch.isnan(values), nan_key, keys)


def _f64_from_keys(keys: torch.Tensor, is_min: bool) -> torch.Tensor:
    nan_key = torch.iinfo(torch.int64).min if is_min else torch.iinfo(torch.int64).max
    bits = torch.where(keys >= 0, keys, keys ^ _F64_LOW63)
    return torch.where(keys == nan_key, _CANONICAL_NAN, bits).view(torch.float64)


def segment_minmax_plain(
    state: torch.Tensor, values: torch.Tensor, seg_ids: torch.Tensor,
    mask: Optional[torch.Tensor], is_min: bool,
) -> torch.Tensor:
    """Plain version of H11: ``state[g] = min/max(state[g], v)`` over the
    valid rows, IN PLACE; returns ``state``. Integers compare as themselves;
    f64 by H11's order keys, so -0.0 < +0.0, a NaN value wins and is written
    as the canonical quiet NaN, and a NaN already in the state stays."""
    ok, idx = _valid(seg_ids, state.shape[0], mask)
    reduce = "amin" if is_min else "amax"
    if state.dtype != torch.float64:
        state.scatter_reduce_(0, idx[ok], values[ok].to(state.dtype), reduce, include_self=True)
        return state
    keys = _f64_keys(state, is_min)
    keys.scatter_reduce_(0, idx[ok], _f64_keys(values[ok], is_min), reduce, include_self=True)
    return state.copy_(torch.where(torch.isnan(state), state, _f64_from_keys(keys, is_min)))


def segment_minmax(
    state: torch.Tensor, values, seg_ids: torch.Tensor,
    mask: Optional[torch.Tensor], is_min: bool,
) -> torch.Tensor:
    """``state[g] = min/max(state[g], v)`` over the valid rows, in place on
    ``state`` (int64 or f64). ``values`` is a column or a ``Narrow`` (a
    narrowed int64 column: H11 reads its staged bytes and adds the offset,
    the plain version widens it). H11 on CUDA; a column H11 does not read as
    it lies is cast to the state's dtype first."""
    seg_ids = seg_ids.to(torch.int32)
    if not seg_ids.is_cuda:
        return segment_minmax_plain(state, widen(values).to(state.dtype), seg_ids, mask, is_min)
    if isinstance(values, Narrow):
        col, off = values.values, values.offset
    else:
        col, off = values, 0
        if state.dtype == torch.float64 or col.dtype not in kernels.SUM_ROW_KINDS:
            col = col.to(state.dtype)
    return kernels.segment_minmax(
        col.contiguous(), seg_ids.contiguous(), mask, state, is_min, off
    )


def minmax_pick(a: torch.Tensor, b: torch.Tensor, is_min: bool) -> torch.Tensor:
    """Elementwise min/max of two states in H11's order (jnp.minimum /
    jnp.maximum's: NaN propagates, -0.0 < +0.0): the UDAs' merge."""
    out = a.clone()
    idx = torch.arange(a.shape[0], device=a.device)
    return segment_minmax_plain(out, b, idx, None, is_min)


def _filled(values, num_segments: int, is_min: bool) -> torch.Tensor:
    """The identity-filled state of ``values``' dtype (int64 for a
    ``Narrow``)."""
    if isinstance(values, Narrow):
        dtype, device = torch.int64, values.values.device
    else:
        dtype, device = values.dtype, values.device
    ident = _identity_for(dtype, is_min)
    return torch.full((num_segments,), ident, dtype=dtype, device=device)


def seg_min(
    values, seg_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment min of int64 or f64 values (or a ``Narrow``); empty
    segments hold the identity (+inf, int64 max), as the reference's scatter
    lane gives."""
    return segment_minmax(_filled(values, num_segments, True), values, seg_ids, mask, True)


def seg_max(
    values, seg_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment max of int64 or f64 values (or a ``Narrow``); empty
    segments hold the identity (-inf, int64 min)."""
    return segment_minmax(_filled(values, num_segments, False), values, seg_ids, mask, False)


def seg_any(
    values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment "any nonzero" as the reference computes it: the max of
    the values as integers, masked rows counting 0, cast to bool, so a
    segment that no row reaches holds the identity and reads True."""
    v = values.to(torch.int64)
    if mask is not None:
        v = torch.where(mask, v, 0)
    return seg_max(v, seg_ids, num_segments).to(torch.bool)


def flat_segment_ids(
    gids: torch.Tensor, inner_ids: torch.Tensor, inner_size: int
) -> torch.Tensor:
    """(group, bucket) -> flat segment id gids * inner_size + inner, int32."""
    return gids.to(torch.int32) * inner_size + inner_ids.to(torch.int32)


# -- sort-merge join primitives (pixie_tpu/ops/segment.py:497-590) -----------
# A stable sort orders the build keys (torch.sort, a library primitive), H13
# probes each probe key into them, a cumsum of the fanouts gives each probe
# row its first pair slot, H14 writes the pairs, and H12 compacts the
# unmatched row indices of the outer variants. Keys are int32 ids of one
# shared key space; padded build rows carry the sentinel K and padded probe
# rows K + 1, so neither pairs.


def join_probe_plain(
    sorted_keys: torch.Tensor, keys: torch.Tensor, present_size: int = 0
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of H13: (lo, fanout, present) — the left searchsorted of
    each probe key, its count of equal build keys, and (``present_size`` >
    0) whether each key id in [0, present_size) occurs among the probe
    keys."""
    lo = torch.searchsorted(sorted_keys, keys, side="left").to(torch.int32)
    hi = torch.searchsorted(sorted_keys, keys, side="right").to(torch.int32)
    present = None
    if present_size:
        present = torch.zeros(present_size, dtype=torch.bool, device=keys.device)
        inside = (keys >= 0) & (keys < present_size)
        present[keys[inside].long()] = True
    return lo, hi - lo, present


def join_probe(
    sorted_keys: torch.Tensor, keys: torch.Tensor, present_size: int = 0, key_space: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """H13 on CUDA, ``join_probe_plain`` on the CPU. ``key_space`` > 0 says
    the keys are ids of [0, key_space), which lets H13 look each up in a
    table of every id's bounds; it changes no result."""
    if keys.is_cuda:
        return kernels.join_probe(
            sorted_keys.contiguous(), keys.contiguous(), present_size, key_space
        )
    return join_probe_plain(sorted_keys, keys, present_size)


def join_emit_pairs_plain(
    lo: torch.Tensor, fanout: torch.Tensor, prefix: torch.Tensor, order: torch.Tensor,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of H14, the reference's formulation: slot t belongs to
    the first probe row whose inclusive prefix exceeds t (clamped to the last
    row), at build position lo + (t - its first slot), clamped into
    ``order``. Every slot is filled; those past the match count hold what
    the clamps give, as the reference's do."""
    n, nb = lo.shape[0], order.shape[0]
    t = torch.arange(cap, dtype=torch.int32, device=lo.device)
    probe_rows = torch.clamp(
        torch.searchsorted(prefix, t, side="right").to(torch.int32), max=n - 1
    )
    pr = probe_rows.long()
    base = prefix[pr] - fanout[pr]
    build_pos = torch.clamp(lo[pr] + (t - base), 0, nb - 1)
    return order[build_pos.long()], probe_rows


def join_emit_pairs(
    lo: torch.Tensor, fanout: torch.Tensor, prefix: torch.Tensor, order: torch.Tensor,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(build_rows, probe_rows), int32 [cap], probe-row-major; only the slots
    below the match count are defined. H14 on CUDA."""
    if lo.is_cuda:
        return kernels.join_emit_pairs(lo, fanout, prefix, order, cap)
    return join_emit_pairs_plain(lo, fanout, prefix, order, cap)


def merge_join_pairs(
    sorted_build_keys: torch.Tensor, build_order: torch.Tensor, probe_keys: torch.Tensor,
    pair_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``pair_cap`` (build_row, probe_row) pairs of an equijoin between
    the SORTED build keys (``build_order`` = each sorted position's build
    row, from one stable sort) and the probe keys: probe row p's pairs
    occupy slots [prefix[p] - fanout[p], prefix[p]), its build rows in
    sorted order. Returns (build_rows, probe_rows, valid, fanout), int32
    but the bool ``valid`` (slot < match count); slots past the count are
    undefined. Callers guarantee the match count fits int32."""
    lo, fanout, _ = join_probe(sorted_build_keys, probe_keys)
    prefix = torch.cumsum(fanout, 0, dtype=torch.int32)
    build_rows, probe_rows = join_emit_pairs(lo, fanout, prefix, build_order, pair_cap)
    total = prefix[-1] if prefix.numel() else torch.zeros((), dtype=torch.int32)
    valid = torch.arange(pair_cap, device=probe_keys.device) < total
    return build_rows, probe_rows, valid, fanout


def compact_unmatched_rows(unmatched: torch.Tensor, cap: int) -> torch.Tensor:
    """The indices of the ``unmatched`` rows in row order, int32 [cap];
    entries past their count are ``n`` (padding), as the reference's
    sentinel sort gives. On CUDA one launch of H12's index lane, which
    writes the indices and the padding."""
    return scan.compact_indices(unmatched.contiguous(), cap)


def local_sort_merge(
    lkey: torch.Tensor, rkey: torch.Tensor, lmask: torch.Tensor, rmask: torch.Tensor,
    cap_m: int, cap_r: int, cap_l: int, num_keys: int,
):
    """The sort -> merge -> compact core of the join lane over sentinel-
    applied int32 keys of ``num_keys`` real ids (build padding ``num_keys``,
    probe padding ``num_keys + 1``). Returns (build_rows, probe_rows, fanout,
    ur, ul): the pairs, each probe row's match count, and the compacted
    unmatched probe rows (cap_r) and build rows (cap_l), None where the cap
    is 0. A build row is matched iff its key occurs among the probe keys:
    H13's presence array over [0, num_keys + 2), the key space H13 takes."""
    sorted_keys, order = torch.sort(lkey, stable=True)
    order = order.to(torch.int32)
    lo, fanout, present = join_probe(
        sorted_keys, rkey, num_keys + 2 if cap_l else 0, num_keys + 2
    )
    prefix = torch.cumsum(fanout, 0, dtype=torch.int32)
    build_rows, probe_rows = join_emit_pairs(lo, fanout, prefix, order, cap_m)
    ur = compact_unmatched_rows(rmask & (fanout == 0), cap_r) if cap_r else None
    ul = None
    if cap_l:
        ul = compact_unmatched_rows(lmask & ~present[lkey.long()], cap_l)
    return build_rows, probe_rows, fanout, ur, ul


def join_gather_plain(
    col: torch.Tensor, sections: list, offset: Optional[int], null_value,
) -> torch.Tensor:
    """Plain version of H15: each (index or None, rows) section of the
    output, an index section gathering ``col`` at the clamped index (widened
    to int64 plus ``offset`` for a narrowed column), an index-less one
    ``null_value``; concatenated."""
    src = col.to(torch.int64) if offset is not None else col
    parts = []
    for idx, rows in sections:
        if not rows:
            continue
        if idx is None:
            parts.append(torch.full((rows,), null_value, dtype=src.dtype, device=col.device))
            continue
        g = src[torch.clamp(idx[:rows].long(), 0, col.shape[0] - 1)]
        parts.append(g + offset if offset is not None else g)
    if not parts:
        return torch.empty(0, dtype=src.dtype, device=col.device)
    return torch.cat(parts)


def join_gather(
    col: torch.Tensor, sections: list, offset: Optional[int], null_value,
) -> torch.Tensor:
    """One join output column from its three sections (matched, unmatched
    probe, unmatched build). H15 on CUDA."""
    if col.is_cuda:
        return kernels.join_gather(col.contiguous(), sections, offset, null_value)
    return join_gather_plain(col, sections, offset, null_value)


# -- the join-aggregate lane's weighted fold (pixie_tpu/parallel/pipeline.py
# _run_left_join_agg, :2664-2732) ---------------------------------------------
def _left_rows(left_vals, n: int, device) -> torch.Tensor:
    """The left sums' columns as one f64 [S_l, n] tensor (a sequence of [n]
    columns stacked; an [S_l, n] tensor as it is)."""
    if isinstance(left_vals, torch.Tensor):
        return left_vals
    rows = list(left_vals)
    if not rows:
        return torch.empty((0, n), dtype=torch.float64, device=device)
    return torch.stack(rows)


def join_agg_fold_plain(
    jk, gids: torch.Tensor, mask: Optional[torch.Tensor],
    n_right: torch.Tensor, left_vals, right_sums: torch.Tensor,
    acc: torch.Tensor, eff_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of H16: over the rows with ``mask`` and a weight
    w = n_right[jk] > 0 (a key outside [0, K) weighs 0), adds w, each left
    value times w and each gathered right sum into acc[:, gids] IN PLACE (a
    gid outside [0, cap) adds nothing); returns ``acc``. Writes the effective
    mask (mask & w > 0) into ``eff_mask`` when given. Rows that fail it are
    left out, never multiplied by a zero weight (Fault-7). ``jk`` is an
    integer column or a ``Narrow``, ``gids`` any integer column, both widened
    to int64; ``left_vals`` S_l f64 [n] columns or an f64 [S_l, n] tensor."""
    jk, gids = widen(jk).to(torch.int64), gids.to(torch.int64)
    left = _left_rows(left_vals, jk.shape[0], jk.device)
    K, cap = n_right.shape[0], acc.shape[1]
    S_l = left.shape[0]
    k_ok = (jk >= 0) & (jk < K)
    kk = torch.where(k_ok, jk, 0)
    w = torch.where(k_ok, n_right[kk], 0.0)
    eff = w > 0
    if mask is not None:
        eff = eff & mask
    if eff_mask is not None:
        eff_mask.copy_(eff)
    ok = eff & (gids >= 0) & (gids < cap)
    g, wk, kr = gids[ok], w[ok], kk[ok]
    acc[0].index_add_(0, g, wk)
    if S_l:
        acc[1 : 1 + S_l].index_add_(1, g, left[:, ok] * wk)
    if right_sums.shape[0]:
        acc[1 + S_l :].index_add_(1, g, right_sums[:, kr])
    return acc


def join_agg_fold(
    jk, gids: torch.Tensor, mask: Optional[torch.Tensor],
    n_right: torch.Tensor, left_vals, right_sums: torch.Tensor,
    acc: torch.Tensor, eff_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The join-aggregate lane's left-side fold of one block: the join's
    count, the weighted left sums and the gathered right sums per group in
    ``acc`` (f64 [1 + S_l + S_r, cap], in place), and the effective mask.
    ``jk`` (a column or a ``Narrow``) and ``gids`` as the fold staged them,
    ``left_vals`` S_l f64 [n] columns (or an f64 [S_l, n] tensor). H16 on
    CUDA reads each where it lies (uint8, uint16 or int32; other keys are
    widened and clamped to [-1, K] first, which weighs every key outside
    [0, K) 0 as before; other gids cast to int32)."""
    col, off = (jk.values, jk.offset) if isinstance(jk, Narrow) else (jk, 0)
    if not col.is_cuda:
        return join_agg_fold_plain(jk, gids, mask, n_right, left_vals, right_sums, acc, eff_mask)
    if col.dtype not in kernels.JOIN_AGG_KINDS:
        col, off = widen(jk).to(torch.int64).clamp(-1, n_right.shape[0]).to(torch.int32), 0
    if gids.dtype not in kernels.JOIN_AGG_KINDS:
        gids = gids.to(torch.int32)
    return kernels.join_agg_fold(
        col.contiguous(), gids.contiguous(), mask, n_right.contiguous(),
        [c.contiguous() for c in left_vals], right_sums.contiguous(), acc, eff_mask,
        jk_offset=off,
    )
