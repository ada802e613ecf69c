"""The hand kernels (H1-H32 and the hash kernel) against their plain PyTorch
versions on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and skips
without one; the mesh tests over real cards need a second card (two of
them, at 4, a fourth). The file imports neither JAX nor the reference package, so it also
runs on a machine that has only PyTorch:
``python -m pytest --noconftest tests/test_torch_kernels.py``.

Tolerances: integer results exactly equal; f64 sums within 1e-12 * sum|v|
per group (H2's bound, PERF.md); log-histogram counts exactly equal once the
rows whose bin coordinate lies within 2.5e-4 of a bin edge are left out (the
Fault-1 contract); H4's quantiles bit for bit with the plain version on the
same card (its values come from ``histogram.midpoint_table``). Sketches:
hashes bit for bit, HLL registers and count-min cells and totals exactly,
HLL estimates within a relative 1e-12; t-digest group weights exactly, at
most 1% of (group, cluster) cells moved by the Fault-4 contract against the
CPU's plain version, means of the others within B * (w + 2) * 2^-24 *
max|v| after B blocks; H9's quantiles bit for bit with the plain version on
the same card for every group of whole weights totalling at most 2^24
(``tdigest.quantile_exact_groups``: every digest a path makes), within
``quantile_edges.td_inexact_tol`` (a bound a value) for the others; H7's
and H8's weights bit for bit with the plain version on the same card, H8's
means within 2C * 2^-24 * max|mean|. H3 in each of its lanes: counts exact
off bin edges, totals exact. Segment min/max (H11) and the scan's
compaction (H12) bit for bit, NaN, signed zeros and subnormals included.
The join's probe (H13), pair emission (H14) on the slots below the match
count, gathers (H15) and unmatched-row compaction (H12 over row indices)
exactly. The join-aggregate fold (H16): the count row and the effective
mask exactly, every sum within 1e-12 * sum |terms| of its cell (H2's bound).
The scalar-expression interpreter (H17): bool, int and f64 outputs bit for
bit, the f64 transcendentals within 2 ulp. The codec's decodes (H18, H19)
bit for bit; the cell lane's HLL registers, count-min cells and totals
(H20, H21) exactly. The batched fold: H22's slot bits bit for bit, H23's
integer sums and presence exactly and its f64 sums within 1e-12 * sum |v|
of their cell (H2's bound). The resident ring's converters (H24) bit for
bit, NaN payloads and f32 subnormals included. The ML lane: H25's
priorities and H26's reservoir states bit for bit (forced ties, 1 to 4096
groups, one group holding every row, empty groups, k 1 to 768, merges),
H27's k-means centers and H28's embeddings within 1e-5 (H27's with the
plain version's NaN pattern where a point holds NaN or an infinity, and
exact on ties). The cross-shard
merge (H29) bit for bit, NaN, signed zeros and int64 overflow included; the
sharded fold over real cards equal to the same geometry over logical shards
of one card, exactly but for f64 sums (within 1e-12 * sum |v|), and so are
the partitioned join and a checkpointed resume over 2 and 4 cards. The
kernels no path calls (H30 count-min query, H31 hash_columns, H32 clz64)
exactly.
"""

import json
import math

import numpy as np
import pytest
import torch

from pixie_tpu_torch.ops import (
    batched, countmin, hashing, histogram, hll, kernels, kmeans_edges, ml, pred_edges, scan,
    segment, tdigest,
)
from pixie_tpu_torch.ops import transformer
from pixie_tpu_torch.ops.quantile_edges import (
    HIST_EDGE_GROUPS, HIST_NBINS, QS_WIDE, TD_CAPACITIES, TD_EDGE_GROUPS, hist_edge_state,
    td_edge_state, td_inexact_tol,
)
from pixie_tpu_torch.ops.tdigest_edges import H8_CASES, h8_expected_branches, h8_inputs

EDGE = 2.5e-4
SPEC = histogram.DEFAULT_SPEC
QS = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)


def _need_cards(n: int) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


def _near_edge(v: np.ndarray) -> np.ndarray:
    x = np.log(np.maximum(v, SPEC.min_value) / SPEC.min_value) / np.log(SPEC.gamma)
    return np.abs(x - np.round(x)) <= EDGE


def _segment_inputs(seed: int, n: int, S: int):
    rng = np.random.default_rng(seed)
    gids = torch.from_numpy(rng.integers(-3, S + 3, n).astype(np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.8)
    ints = rng.integers(-(2**63), 2**63 - 1, (2, n), dtype=np.int64)
    ints[:, :64] = np.iinfo(np.int64).max - rng.integers(0, 4, 64)  # wrap
    floats = rng.exponential(3e7, n)
    return gids, mask, torch.from_numpy(ints), torch.from_numpy(floats)


def _check_segment_kernels(dev: torch.device) -> None:
    n = 20_000
    for S in (16, 4096, 32768):  # shared partials, then the global path
        gids, mask, ints, floats = _segment_inputs(S, n, S)
        want = segment.segment_rows_sum_i64_plain(ints, gids, mask, S)
        got = kernels.segment_rows_sum_i64(ints.to(dev), gids.to(dev), mask.to(dev), S)
        assert got.device == dev
        assert torch.equal(got.cpu(), want)
        want = segment.segment_sum_f64_plain(floats, gids, mask, S)
        got = kernels.segment_rows_sum_f64(
            [(floats.to(dev), 0, False)], gids.to(dev), mask.to(dev), S)[0]
        abs_sum = segment.segment_sum_f64_plain(floats.abs(), gids, mask, S)
        assert torch.all((got.cpu() - want).abs() <= 1e-12 * abs_sum)


def _check_histogram_kernels(dev: torch.device) -> None:
    rng = np.random.default_rng(3)
    v = rng.exponential(3e7, 1 << 18).astype(np.float32)
    v = v[~_near_edge(v.astype(np.float64))]
    n = v.size
    for S in (16, 64):  # shared counts, then global
        gids = torch.from_numpy(rng.integers(0, S, n).astype(np.int32))
        mask = torch.from_numpy(rng.random(n) < 0.9)
        vals = torch.from_numpy(v)
        want = histogram.update_plain(histogram.init(S, "cpu"), gids, vals, mask)
        got = kernels.log_histogram_update(
            vals.to(dev), gids.to(dev), mask.to(dev), histogram.init(S, dev),
            SPEC.min_value, math.log(SPEC.gamma),
        )
        assert got.device == dev
        assert torch.equal(got.cpu(), want)
        q = kernels.hist_quantiles(
            got, torch.tensor(QS, dtype=torch.float64, device=dev),
            histogram.midpoint_table(SPEC, dev),
        )
        assert torch.equal(q, histogram.quantile_values_plain(got, QS))


def _check_sketch_kernels(dev: torch.device) -> None:
    rng = np.random.default_rng(7)
    n = 50_000
    words = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    words[:6] = [0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1024, 65534]
    words[6:9] = np.array([0.0, -0.0, np.nan]).view(np.int64)
    w = torch.from_numpy(words)
    for seed in (0, 1):
        got = kernels.hash32(w.to(dev), seed, pair=True).cpu().to(torch.int64) & 0xFFFFFFFF
        a, b = hashing.hash32_pair_plain(w, seed)
        assert torch.equal(got[0], a) and torch.equal(got[1], b)
        one = kernels.hash32(w.to(dev), seed, pair=False).cpu().to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(one[0], hashing.hash32_plain(w, seed))
    mask = torch.from_numpy(rng.random(n) < 0.9)
    for G in (16, 300):  # shared-memory registers, then global
        gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32))
        vals = torch.from_numpy(rng.integers(1024, 65535, n))
        want = hll.update_plain(hll.init(G, "cpu"), gids, vals, mask)
        got = hll.update(hll.init(G, dev), gids.to(dev), vals.to(dev), mask.to(dev))
        assert torch.equal(got.cpu(), want)
        torch.testing.assert_close(
            hll.estimate(got).cpu(), hll.estimate_plain(want), rtol=1e-12, atol=0
        )
        assert torch.equal(hll.estimate_rounded(got).cpu(), torch.round(hll.estimate_plain(want)).long())
    G = 16
    gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32))
    status = torch.from_numpy(rng.choice(np.array([200, 301, 404, 500]), n))
    cm_w, tot_w = countmin.update_counted(
        countmin.init(G, "cpu"), torch.zeros(G, dtype=torch.int64), gids, status, mask
    )
    cm_g, tot_g = countmin.update_counted(
        countmin.init(G, dev), torch.zeros(G, dtype=torch.int64, device=dev),
        gids.to(dev), status.to(dev), mask.to(dev),
    )
    assert torch.equal(cm_g.cpu(), cm_w) and torch.equal(tot_g.cpu(), tot_w)
    for G in (16, 300):  # packed keys, then (group, value) int64 keys
        want, got = tdigest.init(G, "cpu"), tdigest.init(G, dev)
        vmax, blocks = 0.0, 3
        for _ in range(blocks):
            gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32))
            v = torch.from_numpy(rng.exponential(3e7, n))
            vmax = max(vmax, float(v.float().abs().max()))
            want = tdigest.update(want, gids, v, mask)
            got = tdigest.update(got, gids.to(dev), v.to(dev), mask.to(dev))
        gw, ww = got["weights"].cpu(), want["weights"]
        assert torch.equal(gw.sum(dim=1), ww.sum(dim=1))
        same = gw == ww
        assert (~same).float().mean().item() <= 0.01
        bound = blocks * (ww.double() + 2) * 2.0**-24 * vmax
        err = (got["means"].cpu().double() - want["means"].double()).abs()
        assert torch.all(err[same] <= bound[same])
        q = tdigest.quantile_values(want_dev := {k: t.to(dev) for k, t in want.items()}, QS)
        assert bool(tdigest.quantile_exact_groups(want_dev["weights"]).all())
        assert torch.equal(q, tdigest.quantile_values_plain(want_dev, QS))
        merged = tdigest.merge(want_dev, want_dev)
        plain = tdigest.merge_plain(want, want)
        assert torch.equal(merged["weights"].cpu().sum(dim=1), plain["weights"].sum(dim=1))


def _check_minmax_kernel(dev: torch.device) -> None:
    rng = np.random.default_rng(9)
    n = 50_000
    special = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324])
    for S in (16, 4096, 1 << 20):  # shared partials, then global atomics
        gids = rng.integers(-2, S + 2, n).astype(np.int32)
        gids[: special.size] = 3
        mask = rng.random(n) < 0.9
        mask[: special.size] = True
        for dtype in (torch.int64, torch.float64):
            if dtype == torch.int64:
                v = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
            else:
                v = rng.normal(0.0, 1e6, n)
                v[: special.size] = special
            for is_min in (True, False):
                fill = segment._identity_for(dtype, is_min)
                want = torch.full((S,), fill, dtype=dtype)
                segment.segment_minmax_plain(
                    want, torch.from_numpy(v), torch.from_numpy(gids), torch.from_numpy(mask), is_min
                )
                got = torch.full((S,), fill, dtype=dtype, device=dev)
                kernels.segment_minmax(
                    torch.from_numpy(v).to(dev), torch.from_numpy(gids).to(dev),
                    torch.from_numpy(mask).to(dev), got, is_min,
                )
                assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))


def _check_scan_kernel(dev: torch.device) -> None:
    rng = np.random.default_rng(13)
    n = 3 * 2048 * 5 + 17  # a ragged last tile
    blocks = []
    for frac in (0.1, 0.0, 0.5):  # a block with no survivor in the middle
        blocks.append((
            torch.from_numpy(rng.random(n) < frac),
            [torch.from_numpy(rng.integers(0, 1 << 40, n)),
             torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)),
             torch.from_numpy(rng.normal(size=n))],
        ))
    total = sum(int(m.sum()) for m, _ in blocks)
    for limit in (0, 1, 1000, 3000, total + 5):
        out = []
        for where in ("cpu", dev):
            written = torch.zeros(1, dtype=torch.int32, device=where)
            bufs = [torch.zeros(limit, dtype=c.dtype, device=where) for c in blocks[0][1]]
            for mask, cols in blocks:
                scan.compact_rows(mask.to(where), [c.to(where) for c in cols], written, bufs, limit)
            out.append((int(written[0]), [b.cpu() for b in bufs]))
        (w0, b0), (w1, b1) = out
        assert w0 == w1 == min(limit, total)
        assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(b0, b1))


def _join_keys(seed: int, nb: int, n_probe: int, K: int, pad_b: int, pad_p: int):
    """Sentinel-applied join keys as the join lane builds them: build keys
    with many duplicates (key 0 on a tenth of the rows: a large fanout), probe
    keys over [0, K + 3) so some meet no build key, padded rows (mask False)
    keyed K (build) and K + 1 (probe)."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, K, nb).astype(np.int32)
    lk[rng.random(nb) < 0.1] = 0
    lk[lk == 1] = 2  # id 1: probe-only
    rk = rng.integers(0, K, n_probe).astype(np.int32)
    rk[rk == K - 1] = 3  # id K - 1: build-only
    lmask = np.arange(nb) < nb - pad_b
    rmask = np.arange(n_probe) < n_probe - pad_p
    lk = np.where(lmask, lk, K).astype(np.int32)
    rk = np.where(rmask, rk, K + 1).astype(np.int32)
    return [torch.from_numpy(a) for a in (lk, rk, lmask, rmask)]


def _check_join_probe(dev, sk, rk, present_size: int, key_space: int, lane: str,
                      unaligned: bool = False) -> None:
    """H13 in ``lane`` against its plain version: lo, fanout and presence;
    ``unaligned`` puts the probe keys one element into a buffer on the card."""
    assert kernels.join_probe_geometry(rk.shape[0], key_space)[3] == lane
    want = segment.join_probe_plain(sk, rk, present_size)
    keys = rk.to(dev)
    if unaligned:
        keys = torch.empty(rk.shape[0] + 1, dtype=torch.int32, device=dev)[1:]
        keys.copy_(rk)
    got = kernels.join_probe(sk.to(dev), keys, present_size, key_space)
    for a, b in zip(got, want):
        assert (a is None) == (b is None) and (b is None or torch.equal(a.cpu(), b))


def _check_emit_pairs(dev, lo, fanout, order, caps) -> None:
    """H14 against its plain version on the slots below min(M, cap), in the
    lane its launcher takes (the row lane only while the build side has at
    most JOIN_ROWS_LANE_BUILD rows) and, for a build side that small, also
    in the merge lane: ``order`` padded past JOIN_ROWS_LANE_BUILD rows with
    entries no slot reads gives the same pairs."""
    prefix = torch.cumsum(fanout, 0, dtype=torch.int32)
    M, n, nb = int(prefix[-1]), lo.shape[0], order.shape[0]
    orders = [order]
    if nb <= kernels.JOIN_ROWS_LANE_BUILD:
        orders.append(torch.cat([order, torch.full((kernels.JOIN_ROWS_LANE_BUILD + 1 - nb,), -1,
                                                   dtype=torch.int32)]))
    for cap in caps:
        wb, wp = segment.join_emit_pairs_plain(lo, fanout, prefix, order, cap)
        for o, lane in zip(orders, ("rows" if nb <= kernels.JOIN_ROWS_LANE_BUILD else "merge",
                                    "merge")):
            assert kernels.join_emit_pairs_geometry(n, o.shape[0], cap)[3] == lane
            gb, gp = kernels.join_emit_pairs(
                lo.to(dev), fanout.to(dev), prefix.to(dev), o.to(dev), cap
            )
            S = min(M, cap)
            assert torch.equal(gb[:S].cpu(), wb[:S]) and torch.equal(gp[:S].cpu(), wp[:S])


# (seed, build rows, probe rows, padded build rows, padded probe rows); the
# last as tests/test_torch_join.py's heavy case: fanouts of 702 to 3912 with
# fanout-0 rows between them. Build sides of 256 rows and fewer take H14's
# row lane, larger ones its merge lane.
JOIN_CASES = ((0, 256, 3001, 37, 5), (1, 7, 1, 0, 0), (2, 5000, 20000, 1000, 0),
              (24, 1 << 15, 12, 100, 2))


def _check_join_kernels(dev: torch.device) -> None:
    K = 40
    for seed, nb, n_probe, pad_b, pad_p in JOIN_CASES:
        lk, rk, lmask, rmask = _join_keys(seed, nb, n_probe, K, pad_b, pad_p)
        sk, order = torch.sort(lk, stable=True)
        order = order.to(torch.int32)
        # H13: the search lane (no key space, one above the table, or one
        # too wide for so few probe rows), the table lane (the join's own key
        # space, or the widest any probe side tables), keys outside the table
        # (some negative, some at or past a narrower key space), and
        # unaligned keys (the table lane's row-at-a-time loop).
        _check_join_probe(dev, sk, rk, K + 2, 0, "search")
        _check_join_probe(dev, sk, rk, K + 2, kernels.JOIN_TABLE_IDS + 1, "search")
        _check_join_probe(dev, sk, rk, K + 2, kernels.JOIN_TABLE_ALWAYS_IDS, "search")
        _check_join_probe(dev, sk, rk, K + 2, K + 2, "table")
        _check_join_probe(dev, sk, rk, 0, K + 2, "table")
        _check_join_probe(dev, sk, rk, K + 2, kernels.JOIN_TABLE_ALWAYS_IDS - 1, "table")
        outside = torch.where(torch.arange(n_probe) % 7 == 3, -rk - 1, rk)
        _check_join_probe(dev, sk, outside, K + 2, K // 2, "table")
        _check_join_probe(dev, sk, outside, K // 3, K // 2, "table")
        _check_join_probe(dev, sk, rk, K + 2, K + 2, "table", unaligned=True)
        lo, fanout, _ = segment.join_probe_plain(sk, rk)
        M = int(fanout.sum())
        # H14: a cap at the count, above it, and through the heaviest row.
        heavy = int(torch.argmax(fanout))
        cut = int(fanout[: heavy + 1].sum()) - int(fanout[heavy]) // 2
        _check_emit_pairs(dev, lo, fanout, order, (M, M + 9, max(cut, 1)))
        for cap_r, cap_l in ((0, 0), (64, 0), (0, 64), (4096, 1024)):
            want = segment.local_sort_merge(lk, rk, lmask, rmask, M, cap_r, cap_l, K)
            got = segment.local_sort_merge(
                lk.to(dev), rk.to(dev), lmask.to(dev), rmask.to(dev), M, cap_r, cap_l, K
            )
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
            assert torch.equal(got[2].cpu(), want[2])
            for g, w in zip(got[3:], want[3:]):
                assert (g is None) == (w is None)
                assert g is None or torch.equal(g.cpu(), w)
            ur, ul = want[3], want[4]
        # H15 over every column type staging produces, null sections included.
        rng = np.random.default_rng(seed)
        cols = [
            (torch.from_numpy(rng.integers(0, 256, nb).astype(np.uint8)), 7, -1),
            (torch.from_numpy(rng.integers(0, 65536, nb).astype(np.uint16)), -3, 0),
            (torch.from_numpy(rng.integers(0, 1 << 31, nb).astype(np.int32)), 1 << 40, 0),
            (torch.from_numpy(rng.integers(0, 16, nb).astype(np.int32)), None, -1),
            (torch.from_numpy(rng.integers(-(2**62), 2**62, nb)), None, 0),
            (torch.from_numpy(rng.normal(size=nb)), None, 0),
            (torch.from_numpy(rng.random(nb) < 0.5), None, 0),
        ]
        sections = [(want[0], M), (None, 4096), (ul, 1024)]
        for col, offset, null in cols:
            w = segment.join_gather_plain(col, sections, offset, null)
            g = kernels.join_gather(
                col.to(dev), [(i.to(dev) if i is not None else None, r) for i, r in sections],
                offset, null,
            )
            assert g.dtype == w.dtype and torch.equal(g.cpu().view(torch.uint8), w.view(torch.uint8))
        # H12 over an int32 row-index column: the unmatched probe rows.
        got = segment.compact_unmatched_rows((rmask & (fanout == 0)).to(dev), 4096)
        assert torch.equal(got.cpu(), ur)
    # H13 over the widest key space its table holds: tabled from
    # JOIN_TABLE_ROWS_PER_ID probe rows a bound on, searched one row short of
    # that, and searched above the table's size; with presence over every id.
    ids = kernels.JOIN_TABLE_IDS
    rng = np.random.default_rng(8)
    sk = torch.sort(torch.from_numpy(rng.integers(0, ids, 5000).astype(np.int32)))[0]
    busy = kernels.JOIN_TABLE_ROWS_PER_ID * (ids + 1)
    rk = torch.from_numpy(rng.integers(-3, ids + 3, busy).astype(np.int32))
    _check_join_probe(dev, sk, rk, ids, ids, "table")
    _check_join_probe(dev, sk, rk[1:], ids, ids, "search")
    _check_join_probe(dev, sk, rk, ids + 1, ids + 1, "search")
    # One probe row of more than 2^20 pairs between rows of none and of a few.
    rng = np.random.default_rng(7)
    lk = torch.from_numpy(np.where(rng.random((1 << 20) + 5000) < 0.998, 0,
                                   rng.integers(1, 4, (1 << 20) + 5000)).astype(np.int32))
    rk = torch.tensor([2, 5, 0, 5, 3, 1, 0], dtype=torch.int32)
    sk, order = torch.sort(lk, stable=True)
    lo, fanout, _ = segment.join_probe_plain(sk, rk)
    assert int(fanout.max()) > 1 << 20
    _check_join_probe(dev, sk, rk, 8, 8, "table")
    _check_emit_pairs(dev, lo, fanout, order.to(torch.int32), (int(fanout.sum()), 1 << 19))


@pytest.mark.cuda
def test_join_kernels_match_plain_on_card():
    _need_cards(1)
    _check_join_kernels(torch.device("cuda", 0))


@pytest.mark.cuda
def test_minmax_kernel_matches_plain_on_card():
    _need_cards(1)
    _check_minmax_kernel(torch.device("cuda", 0))


@pytest.mark.cuda
def test_scan_kernel_matches_plain_on_card():
    _need_cards(1)
    _check_scan_kernel(torch.device("cuda", 0))


def _h12_mask(rng, n: int, count: int) -> torch.Tensor:
    mask = np.zeros(n, bool)
    mask[rng.choice(n, count, replace=False)] = True
    return torch.from_numpy(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 17, 4096, 4097, 3 * 4096 * 7 + 5, (1 << 21) + 5, 1 << 22])
def test_scan_compact_index_lane_edges_on_card(n):
    """H12's index lane against the plain version, bit for bit: counts 0,
    1, a seventh and every row, caps 1, at the count, past it and past n
    (padding ``n``), one CTA and many shares; an unaligned mask (row-wise
    loads); fifty launches queued on one stream (each its own epoch) and
    launches on a second stream (its own status words)."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n)
    for count in sorted({0, 1, n // 7, n}):
        mask = _h12_mask(rng, n, count)
        card = mask.to(dev)
        for cap in sorted({1, max(count, 1), count + 7, n + 100}):
            want = scan.compact_indices_plain(mask, cap)
            assert torch.equal(kernels.scan_compact_indices(card, cap).cpu(), want), (count, cap)
            assert torch.equal(segment.compact_unmatched_rows(card, cap).cpu(), want)
        got = kernels.scan_compact_indices(_unaligned(card), count + 3)
        assert torch.equal(got.cpu(), scan.compact_indices_plain(mask, count + 3)), count
    masks = [_h12_mask(rng, n, int(rng.integers(0, n + 1))) for _ in range(5)]
    cards = [m.to(dev) for m in masks]
    outs = [kernels.scan_compact_indices(cards[i % 5], n) for i in range(50)]
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        side_outs = [kernels.scan_compact_indices(c, n) for c in cards]
    side.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out.cpu(), scan.compact_indices_plain(masks[i % 5], n)), i
    for m, out in zip(masks, side_outs):
        assert torch.equal(out.cpu(), scan.compact_indices_plain(m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 5000, (1 << 21) + 5])
def test_scan_compact_edges_on_card(n):
    """H12 over columns against the plain version, bit for bit (written and
    every buffer, slots past the count untouched): ``written`` 0, inside the
    limit, one short of it, at it and past it (the launch returns at once);
    a limit that ends inside a later share; an unaligned mask and unaligned
    columns; no columns at all (``written`` alone); CTA 0's probe stamps in
    order."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n + 12)
    mask = _h12_mask(rng, n, int(rng.integers(0, n + 1)) if n > 1 else 1)
    cols = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)),
            torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)),
            torch.from_numpy(rng.normal(size=n))]
    count = int(mask.sum())
    for limit in sorted({0, 1, count // 2 + 1, count, count + 9}):
        for w0 in sorted({0, min(5, limit), max(limit - 1, 0), limit, limit + 3}):
            for skew in (False, True):
                out = []
                for where in ("cpu", dev):
                    written = torch.full((1,), w0, dtype=torch.int32, device=where)
                    bufs = [torch.full((limit + 4,), 7, dtype=c.dtype, device=where) for c in cols]
                    m, cs = mask.to(where), [c.to(where) for c in cols]
                    if skew and where != "cpu":
                        m, cs = _unaligned(m), [_unaligned(c) for c in cs]
                    scan.compact_rows(m, cs, written, bufs, limit)
                    out.append((int(written[0]), [b.cpu() for b in bufs]))
                (wp, bp), (wk, bk) = out
                assert wp == wk, (limit, w0, skew)
                assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                           for x, y in zip(bp, bk)), (limit, w0, skew)
    for limit in (1, count + 9):  # no columns: the count alone
        got = torch.zeros(1, dtype=torch.int32, device=dev)
        kernels.scan_compact(mask.to(dev), [], got, [], limit)
        assert int(got[0]) == min(count, limit)
    probe = torch.zeros(kernels.SCAN_PROBE, dtype=torch.int64, device=dev)
    kernels.scan_compact(mask.to(dev), [c.to(dev) for c in cols],
                         torch.zeros(1, dtype=torch.int32, device=dev),
                         [torch.empty(count + 1, dtype=c.dtype, device=dev) for c in cols],
                         count + 1, probe=probe)
    stamps = probe.cpu().tolist()
    assert all(0 < a <= b for a, b in zip(stamps, stamps[1:])), stamps


@pytest.mark.cuda
def test_sketch_kernels_match_plain_on_card():
    _need_cards(1)
    _check_sketch_kernels(torch.device("cuda", 0))


@pytest.mark.cuda
def test_segment_kernels_match_plain_on_card():
    _need_cards(1)
    _check_segment_kernels(torch.device("cuda", 0))


# H1 and H5 at their edges: row counts around the 8-row vectors and the
# bin grid's 8192-row chunks, views one element into a buffer (no vector
# loads), every staged dtype with offsets that wrap, and S and G on both
# sides of every lane boundary; bit for bit against the plain versions.
EDGE_ROWS = [1, 31, 33, 8191, 8193, 1 << 21]
_I64 = np.iinfo(np.int64)


def _h1_edge_rows(rng, n: int, dev, unaligned: bool) -> list:
    """(tensor or None, offset) rows: bool, uint8, uint16, int32 narrowed,
    int64, each with an offset, and the presence row."""
    def put(a):
        t = torch.from_numpy(a).to(dev)
        return _unaligned(t) if unaligned else t
    return [
        (put(rng.random(n) < 0.5), 0),
        (put(rng.integers(0, 256, n).astype(np.uint8)), int(_I64.max) - 3),
        (put(rng.integers(0, 65536, n).astype(np.uint16)), int(_I64.min) + 11),
        (put(rng.integers(0, 1 << 31, n).astype(np.int32)), int(_I64.max) - (1 << 30)),
        (None, 0),
        (put(rng.integers(_I64.min, _I64.max, n, dtype=np.int64)), -7),
    ]


def _h1_edge_S(optin: int, value_rows: int) -> list:
    """S around the register lane's buckets and the cluster lane's limit."""
    limit = optin // (8 * value_rows + 4)
    assert kernels.h1_lane(value_rows, limit, optin)[0] == "cluster"
    assert kernels.h1_lane(value_rows, limit + 1, optin)[0] == "global"
    return [1, 8, 9, 16, 17, 32, 33, 4096, limit, limit + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_segment_rows_sum_edges_on_card(n):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n)
    optin = kernels.smem_optin_bytes(dev)
    for unaligned in (False, True):
        rows = _h1_edge_rows(rng, n, dev, unaligned)
        value_rows = sum(t is not None for t, _ in rows)
        for S in _h1_edge_S(optin, value_rows):
            gids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32)).to(dev)
            mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
            if unaligned:
                gids, mask = _unaligned(gids), _unaligned(mask)
            plain = [segment.PRESENCE if t is None else segment.Narrow(t, off) for t, off in rows]
            # every row, one value row, the presence row alone, the count alone
            for idx in (range(len(rows)), [0], [4], []):
                sub, psub = [rows[i] for i in idx], [plain[i] for i in idx]
                got = kernels.segment_rows_sum_i64(sub, gids, mask, S)
                want = segment.fused_segment_sums_plain(psub, gids, S, mask)
                assert torch.equal(got, want), (n, S, unaligned, len(sub))
            got = kernels.segment_rows_sum_i64(rows, gids, None, S)
            want = segment.fused_segment_sums_plain(plain, gids, S, None)
            assert torch.equal(got, want), (n, S, unaligned, "no mask")


@pytest.mark.cuda
def test_segment_rows_sum_many_rows_on_card():
    """More rows than one launch takes (kernels.H1_MAX_ROWS): the wrapper
    splits them, each part with its count; in every lane."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    n = 4099
    rows = [r for _ in range(7) for r in _h1_edge_rows(rng, n, dev, False)][:kernels.H1_MAX_ROWS + 8]
    plain = [segment.PRESENCE if t is None else segment.Narrow(t, off) for t, off in rows]
    for S in (16, 4096, 40_000):
        gids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32)).to(dev)
        mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        got = kernels.segment_rows_sum_i64(rows, gids, mask, S)
        want = segment.fused_segment_sums_plain(plain, gids, S, mask)
        assert got.shape == (len(rows) + 1, S) and torch.equal(got, want), S


# H2 at its edges: every row kind (f64, and the integer kinds H1 reads, with
# offsets), both ops, R = 1 to 6 rows a call (the warp lane takes 4 a
# launch), views one element into a buffer, NaN and +-inf, S on both sides
# of every lane's edge; each row within 1e-12 * sum |v| of the plain
# version, integer rows whose sums stay below 2^53 exactly, non-finite sums
# where the plain version has them, and the private and warp lanes the same
# bits twice.
def _h2_edge_rows(rng, n: int, dev, unaligned: bool) -> list:
    """(tensor, offset, square) rows of every kind H2 reads."""
    def put(a):
        t = torch.from_numpy(a).to(dev)
        return _unaligned(t) if unaligned else t
    f = rng.exponential(3e7, n)
    f[rng.random(n) < 1e-3] = np.nan
    f[rng.random(n) < 1e-3] = np.inf
    f[rng.random(n) < 1e-3] = -np.inf
    return [
        (put(rng.normal(0.0, 1e6, n)), 0, False),
        (put(rng.random(n) < 0.5), 0, False),
        (put(rng.integers(0, 256, n).astype(np.uint8)), 7, True),
        (put(rng.integers(0, 65536, n).astype(np.uint16)), -70_000, False),
        (put(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)), int(_I64.max) - 5, False),
        (put(rng.integers(-(2**40), 2**40, n, dtype=np.int64)), 0, True),
        (put(f), 0, False),
        (put(f), 0, True),
    ]


def _h2_check(got: torch.Tensor, rows: list, gids, mask, S: int, what) -> None:
    plain = [segment.F64Row(segment.Narrow(t, off) if off else t, sq) for t, off, sq in rows]
    want = segment.segment_rows_sum_f64_plain(plain, gids, S, mask)
    assert got.shape == want.shape == (len(rows), S), what
    for r, row in enumerate(plain):
        x = segment._f64_row_values(row)
        finite = torch.where(torch.isfinite(x), x, 0.0)
        abs_sum = segment.segment_sum_f64_plain(finite.abs(), gids, mask, S)
        g, w = got[r], want[r]
        assert torch.equal(torch.isnan(g), torch.isnan(w)), (what, r)
        fin = torch.isfinite(w)
        assert torch.equal(g[~fin & ~torch.isnan(w)], w[~fin & ~torch.isnan(w)]), (what, r)
        assert torch.all((g[fin] - w[fin]).abs() <= 1e-12 * abs_sum[fin]), (what, r)
        if rows[r][0].dtype != torch.float64 and bool(torch.all(abs_sum < 2.0**53)) \
                and bool(torch.all(x == torch.round(x))):
            assert torch.equal(g, w), (what, r, "integer row")


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_segment_rows_sum_f64_edges_on_card(n):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n + 7)
    optin = kernels.smem_optin_bytes(dev)
    shared_max = optin // 8  # one row's partial fills the opt-in bytes
    assert kernels.h2_lane(1, shared_max, optin)[0] == "shared"
    assert kernels.h2_lane(1, shared_max + 1, optin)[0] == "global"
    for unaligned in (False, True):
        rows = _h2_edge_rows(rng, n, dev, unaligned)
        for S in (1, 16, 63, 64, 65, 4096, shared_max, shared_max + 1):
            gids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32)).to(dev)
            mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
            if unaligned:
                gids, mask = _unaligned(gids), _unaligned(mask)
            for idx in ([0], [1, 2], [3, 4, 5], [0, 2, 4, 6], [0, 1, 2, 3, 4], list(range(6)),
                        list(range(7)), [6, 7]):
                sub = [rows[i] for i in idx]
                got = kernels.segment_rows_sum_f64(sub, gids, mask, S)
                _h2_check(got, sub, gids, mask, S, (n, S, unaligned, idx))
                if kernels.h2_lane(len(sub), S, optin)[0] in ("private", "warps"):
                    again = kernels.segment_rows_sum_f64(sub, gids, mask, S)
                    assert bits_equal(got, again), (n, S, unaligned, idx, "twice")
            got = kernels.segment_rows_sum_f64(rows[:3], gids, None, S)
            _h2_check(got, rows[:3], gids, None, S, (n, S, unaligned, "no mask"))


@pytest.mark.cuda
def test_segment_rows_sum_f64_sorted_runs_on_card():
    """Gids in long runs (a thread's 8 rows and a warp's lanes share one):
    the register merge and the shuffles add whole runs; S = 1 and 64."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    n = (1 << 20) + 3
    for S in (1, 64):
        gids = torch.from_numpy(np.sort(rng.integers(0, S, n)).astype(np.int32)).to(dev)
        rows = _h2_edge_rows(rng, n, dev, False)[:4]
        got = kernels.segment_rows_sum_f64(rows, gids, None, S)
        _h2_check(got, rows, gids, None, S, ("sorted", S))


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaN payloads and signs of zero included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


# H7b at its edges: an empty group, groups of 1 and 2 rows, every row
# masked, one group holding every row, n off the 16-byte vectors, runs
# across warp and CTA edges, wide keys (G = 300) and the starts scanned
# into scratch (G above kernels.TD_SHARED_STARTS); against the plain
# version under Fault-4: group weights exact, the cells' weights moved only
# by rows whose cluster coordinate lies within 1e-4 of an integer, value
# sums of the other cells within 1e-12.
def _td_near(g_s, G: int, C: int) -> torch.Tensor:
    _, qmid = tdigest._row_clusters(g_s, G, C)
    q = torch.clamp(qmid.double(), float(np.float32(1e-7)), float(np.float32(1 - 1e-7)))
    c = (torch.asin(2 * q - 1) / math.pi + 0.5) * C
    near = ((c - torch.round(c)).abs() <= 1e-4) & (g_s < G)
    return torch.bincount(g_s[near], minlength=G)[:G]


def check_tdigest_cluster(dev, gids: np.ndarray, vals: np.ndarray, mask: np.ndarray, G: int,
                          what, C: int = tdigest.DEFAULT_CAPACITY) -> None:
    g = torch.from_numpy(gids.astype(np.int32)).to(dev)
    v = torch.from_numpy(vals.astype(np.float32)).to(dev)
    m = torch.from_numpy(mask).to(dev)
    keys, counts = kernels.tdigest_pack(v, g, m, G)
    ks = torch.sort(keys).values
    got = kernels.tdigest_cluster(ks, counts, G, C)
    g_s, v_s = tdigest._sorted_rows(g, v, m, G)
    want = tdigest._cluster_sums_plain(g_s, v_s, G, C)
    assert torch.equal(got[0].sum(dim=1), want[0].sum(dim=1)), (what, "group weights")
    dw = (got[0] - want[0]).abs()
    assert bool(torch.all(dw.sum(dim=1) <= 2 * _td_near(g_s, G, C))), (what, "Fault-4")
    same = dw == 0
    verr = (got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-300)
    assert bool(torch.all(verr[same] <= 1e-12)), (what, "value sums")
    # The keys less the first, a view one key in (no vector loads), with
    # the counts of its rows.
    counts1 = counts.clone()
    counts1[int(g_s[0])] -= 1
    got1 = kernels.tdigest_cluster(ks[1:], counts1, G, C)
    want1 = tdigest._cluster_sums_plain(g_s[1:], v_s[1:], G, C)
    assert torch.equal(got1[0].sum(dim=1), want1[0].sum(dim=1)), (what, "unaligned")


TD_EDGE_CASES = ["basic", "empty_group", "tiny_groups", "all_masked", "one_group",
                 "off_vector", "long_runs", "wide", "scratch_starts", "windowed_512"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TD_EDGE_CASES)
def test_tdigest_cluster_edges_on_card(case):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(TD_EDGE_CASES.index(case))
    n, G = 1 << 18, 16
    mask = rng.random(n) < 0.9
    vals = rng.exponential(3e7, n)
    gids = rng.integers(0, G, n)
    if case == "empty_group":
        gids[gids == 3] = 4
    elif case == "tiny_groups":
        gids[gids <= 1] = 2
        gids[:3] = [0, 1, 1]
        mask[:3] = True
    elif case == "all_masked":
        mask[:] = False
    elif case == "one_group":
        gids[:] = 7
    elif case == "off_vector":
        n = (1 << 18) + 7
        mask, vals, gids = rng.random(n) < 0.9, rng.exponential(3e7, n), rng.integers(0, G, n)
    elif case == "long_runs":
        vals = np.repeat(rng.exponential(3e7, n // 4096), 4096)  # equal values: long cells
    elif case == "wide":
        G = 300
        gids = rng.integers(0, G, n)
    elif case == "scratch_starts":
        G = kernels.TD_SHARED_STARTS + 100
        gids = rng.integers(0, G, n)
    elif case == "windowed_512":
        # A windowed fold's block: one window's 16 services of 32 x 16 slots.
        G = 512
        gids = 5 * 16 + rng.integers(0, 16, n)
    check_tdigest_cluster(dev, gids, vals, mask, G, case)


@pytest.mark.cuda
def test_tdigest_wide_lane_update_at_512_slots():
    """``tdigest.update`` of 512 (window, service) slots takes the wide lane
    (H7a, torch.sort, H7b, then H8), never H7, and over three windows' blocks
    equals the plain update on the card: group weights exactly, each
    group's quantiles under the Fault-4 contract (1e-2 of the value plus
    1e-5 of the group's largest)."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(26)
    G, n = 512, 1 << 18
    got, want = tdigest.init(G, dev), tdigest.init(G, dev)
    kernels.reset_launches()
    for w in (0, 7, 31):
        g = torch.from_numpy((w * 16 + rng.integers(0, 16, n)).astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.exponential(3e7, n)).to(dev)
        m = torch.from_numpy(rng.random(n) < 0.95).to(dev)
        got = tdigest.update(got, g, v, m)
        want = tdigest.update_plain(want, g, v, m)
    assert kernels.LAUNCHES["tdigest_update"] == 0
    assert all(kernels.LAUNCHES[k] == 3 for k in ("tdigest_pack", "tdigest_cluster"))
    assert torch.equal(got["weights"].sum(dim=1), want["weights"].sum(dim=1))
    gq = tdigest.quantile_values_plain(got, QS).cpu().numpy()
    wq = tdigest.quantile_values_plain(want, QS).cpu().numpy()
    top = np.abs(wq).max(axis=1, keepdims=True)
    assert np.all(np.abs(gq - wq) <= 1e-2 * np.abs(wq) + 1e-5 * top)


@pytest.mark.cuda
def test_partial_state_batch_stays_on_card():
    """A PEM fragment's PARTIAL fold on the card (the DistributedPlanner's
    split of service_stats over two PEMs) returns a StateBatch whose state
    leaves are on the card, and the Kelvin's MERGE on the card over two of
    them equals the same split on the CPU's plain path: groups, order and
    counts exact, error_rate within 1e-12, quantiles equal or one bin
    apart."""
    _need_cards(1)
    import uuid

    from pixie_tpu_torch.distributed import AgentInfo, DistributedPlanner, DistributedState
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.exec import BridgeRouter
    from pixie_tpu_torch.exec.agg_node import StateBatch
    from pixie_tpu_torch.interop import table_from_columns
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.plan.operators import BridgeSinkOp
    from pixie_tpu_torch.plan.plan import Plan
    from pixie_tpu_torch.types import DataType, Relation

    rng = np.random.default_rng(26)
    rel = Relation.of(("service", DataType.STRING), ("resp_status", DataType.INT64),
                      ("latency", DataType.FLOAT64))
    shards = [{
        "service": np.array([f"svc-{i}" for i in rng.integers(0, 16, n)], dtype=object),
        "resp_status": rng.choice([200, 301, 404, 500], n, p=[0.85, 0.05, 0.05, 0.05]),
        "latency": rng.exponential(3e7, n),
    } for n in (70_000, 50_000)]
    pxl = (
        "df = px.DataFrame(table='t')\n"
        "df.failure = df.resp_status >= 400\n"
        "s = df.groupby(['service']).agg(throughput=('resp_status', px.count),\n"
        "    error_rate=('failure', px.mean), latency=('latency', px.quantiles))\n"
        "px.display(s, 'o')\n"
    )
    out = {}
    for device in ("cuda:0", "cpu"):
        router = BridgeRouter()
        pems = []
        for i, cols in enumerate(shards):
            c = Carnot(router=router, instance=f"pem{i}",
                       device_executor=DeviceExecutor(device=device, block_rows=1 << 14))
            table_from_columns(c.table_store, "t", rel, cols)
            pems.append(c)
        kelvin = Carnot(router=router, instance="kelvin", device=device)
        logical = kelvin.compiler.compile(pxl, {"t": rel}, query_id=str(uuid.uuid4()))
        plan = DistributedPlanner(kelvin.registry, {"t": rel}).plan(logical, DistributedState(
            [AgentInfo(p.instance, frozenset({"t"})) for p in pems]
            + [AgentInfo("kelvin", frozenset(), is_kelvin=True)]))
        for p, frag in zip(pems, plan.fragments[:2]):
            _, sb = p.device_executor.try_execute_fragment(frag, p.table_store, p.registry)
            assert isinstance(sb, StateBatch)
            for st in sb.states.values():
                for leaf in (st.values() if isinstance(st, dict) else [st]):
                    assert leaf.device == torch.device(device)
        subs = {}
        for f in plan.fragments:
            inst = plan.executing_instance[f.fragment_id]
            subs.setdefault(inst, Plan(plan.query_id)).fragments.append(f)
            subs[inst].executing_instance[f.fragment_id] = inst
        for f in plan.fragments:
            for nid in f.nodes():
                if isinstance(f.node(nid), BridgeSinkOp):
                    router.register_producer(plan.query_id, f.node(nid).bridge_id)
        kernels.reset_launches()
        for p in pems:
            p.execute_plan(subs[p.instance], manage_router=False)
        out[device] = kelvin.execute_plan(subs["kelvin"], manage_router=False).table("o")
        if device != "cpu":
            assert all(kernels.LAUNCHES[k] > 0 for k in (
                "segment_rows_sum_i64", "log_histogram_update", "hist_quantiles", "scalar_eval"))
    got, want = out["cuda:0"], out["cpu"]
    assert got["service"] == want["service"] and got["throughput"] == want["throughput"]
    assert np.allclose(got["error_rate"], want["error_rate"], rtol=0, atol=1e-12)
    for gq, wq in zip(got["latency"], want["latency"]):
        g, w = json.loads(gq), json.loads(wq)
        for k in w:
            assert g[k] == w[k] or max(g[k], w[k]) / min(g[k], w[k]) <= SPEC.gamma * (1 + 1e-9)


# H7, the sort-free t-digest update, at its edges: every value equal, two
# values, a group of one row, empty groups, masked rows and gids out of
# range, NaN, +-inf, +-0 and subnormals, G = 1, 16 and 254, and
# exponential(3e7) latencies; against the plain version's sums over the
# sorted rows: the weights bit for bit, the value sums within 1e-12 * sum
# |v| (NaN where the plain version has NaN). The CPU tests hold a
# step-by-step model of H7 against the same plain sums
# (tests/test_torch_sketches.py).
TD_UPDATE_CASES = [("exponential", 1), ("exponential", 16), ("exponential", 254),
                   ("all_equal", 16), ("two_values", 16), ("single_row", 16),
                   ("empty_groups", 16), ("masked", 16), ("specials", 16), ("specials", 254)]
TD_SPECIALS = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-41, 1.4e-45, 5e-324]


def td_update_inputs(case: str, G: int, n: int = 1 << 16, seed: int = 0):
    """(gids int32, f64 values, mask) of a block of H7's edge case."""
    rng = np.random.default_rng([seed, G, [c for c, _ in TD_UPDATE_CASES].index(case)])
    gids = rng.integers(0, G, n)
    mask = rng.random(n) < 0.9
    vals = rng.exponential(3e7, n)
    if case == "all_equal":
        vals[:] = 12345.678
    elif case == "two_values":
        vals = rng.choice(np.array([250.0, 7.5e7]), n)
    elif case == "single_row":
        gids[gids == 3] = 4
        gids[n // 2], mask[n // 2] = 3, True
    elif case == "empty_groups":
        gids[gids % 3 == 1] = 0
    elif case == "masked":
        gids = rng.integers(-2, G + 2, n)
        mask = rng.random(n) < 0.6
    elif case == "specials":
        k = n // 8
        vals[rng.choice(n, k, replace=False)] = rng.choice(np.array(TD_SPECIALS), k)
    return gids.astype(np.int32), vals, mask


def check_tdigest_update(dev, gids: np.ndarray, vals: np.ndarray, mask: np.ndarray, G: int,
                         what, C: int = tdigest.DEFAULT_CAPACITY) -> float:
    """H7 over one block, its values as f64 and as f32, against the plain
    sums; returns the largest |error| of a finite value sum."""
    g = torch.from_numpy(gids).to(dev)
    m = torch.from_numpy(mask).to(dev)
    v32 = torch.from_numpy(vals.astype(np.float32)).to(dev)
    g_s, v_s = tdigest._sorted_rows(g, v32, m, G)
    want = tdigest._cluster_sums_plain(g_s, v_s, G, C)
    scale = tdigest._cluster_sums_plain(g_s, v_s.abs(), G, C)[1]
    worst = 0.0
    for v in (torch.from_numpy(vals).to(dev), v32):
        got = kernels.tdigest_update_sums(v, g, m, G, C)
        assert bits_equal(got[0], want[0]), (what, v.dtype, "weights")
        nan = torch.isnan(want[1])
        assert torch.equal(torch.isnan(got[1]), nan), (what, v.dtype, "NaN cells")
        fin = torch.isfinite(want[1])
        assert torch.equal(got[1][~fin & ~nan], want[1][~fin & ~nan]), (what, "inf cells")
        err = (got[1] - want[1]).abs()[fin]
        assert bool(torch.all(err <= 1e-12 * scale[fin])), (what, v.dtype, "value sums")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("case,G", TD_UPDATE_CASES)
def test_tdigest_update_edges_on_card(case, G):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    for n in (1 << 16, (1 << 21) + 3):
        check_tdigest_update(dev, *td_update_inputs(case, G, n), G, (case, G, n))


# H8, the merge, at its edges (pixie_tpu_torch/ops/tdigest_edges.py)
# against merge_plain on the same device: the weights bit for bit, the
# means within 2C * 2^-24 * max|finite input mean| of the group (f32 sums
# in another order), NaN and inf alike. The CPU tests hold a step-by-step
# model of H8 on the same digests (tests/test_torch_sketches.py).
def assert_h8_means(got: torch.Tensor, want: torch.Tensor, a: dict, b: dict,
                    cells: torch.Tensor, C: int) -> None:
    """Means of ``cells`` within 2C * 2^-24 * max|finite input mean| of the
    group; NaN and inf where ``want`` has them."""
    inputs = torch.cat([a["means"], b["means"].float()], dim=1)
    scale = torch.where(torch.isfinite(inputs), inputs.abs(), 0.0).amax(dim=1, keepdim=True)
    fin = torch.isfinite(want) & cells
    assert torch.equal(torch.isnan(got) & cells, torch.isnan(want) & cells)
    inf = torch.isinf(want) & cells
    assert torch.equal(got[inf], want[inf])
    bound = (2 * C * 2.0**-24 * scale).expand_as(want)
    assert bool(torch.all((got - want).abs()[fin] <= bound[fin]))

def h8_call(a: dict, b: dict, raw_b: bool, probe=None) -> dict:
    b0, b1 = (b["weights"], b["means"]) if raw_b else (b["means"], b["weights"])
    return kernels.tdigest_merge(a["means"], a["weights"], b0, b1, raw_b=raw_b, probe=probe)


@pytest.mark.cuda
@pytest.mark.parametrize("case,G", H8_CASES)
def test_tdigest_merge_edges_on_card(case, G):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    C = tdigest.DEFAULT_CAPACITY
    a, b, raw_b = h8_inputs(case, G, C)
    a, b = ({k: v.to(dev) for k, v in d.items()} for d in (a, b))
    probe = torch.zeros(kernels.TD_MERGE_PROBE, dtype=torch.int64, device=dev)
    got = h8_call(a, b, raw_b, probe)
    bb = tdigest.batch_from_sums(b["weights"], b["means"]) if raw_b else b
    want = tdigest.merge_plain(a, bb)
    assert bits_equal(got["weights"], want["weights"]), case
    assert_h8_means(got["means"].cpu(), want["means"].cpu(), {k: v.cpu() for k, v in a.items()},
                    {k: v.cpu() for k, v in bb.items()}, torch.ones((G, C), dtype=torch.bool), C)
    expect = h8_expected_branches(case, G)
    if expect is not None:
        assert probe[:2].tolist() == expect, (case, probe.tolist())


# H3 in each lane (kernels.h3_lane: S = 16 and 64 the cluster lane, 600
# global atomics) at 2^21 + 3 rows, f32 and f64
# values, with and without a mask, gids out of range, the rows aligned and
# one element into a buffer (no vector loads): exact where no row lies
# within 2.5e-4 of a bin edge; with the edge rows, totals exact and at most
# two cell counts moved a row (the Fault-1 contract: one bin over).
@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 64, 600])
def test_log_histogram_lanes_on_card(S):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(S)
    n = (1 << 21) + 3
    v = rng.exponential(3e7, n)
    v[:6] = [0.0, -3.0, np.nan, np.inf, 1.0, 5e13]
    with np.errstate(invalid="ignore"):  # NaN and inf are near no edge
        near = torch.from_numpy(_near_edge(v))
    gids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32))
    lane = kernels.h3_lane(S, SPEC.nbins, kernels.smem_optin_bytes(dev))[0]
    assert lane == {16: "cluster", 64: "cluster", 600: "global"}[S]
    lg = math.log(SPEC.gamma)
    for mask in (None, torch.from_numpy(rng.random(n) < 0.8)):
        for dtype in (torch.float32, torch.float64):
            vals = torch.from_numpy(v).to(dtype)
            for skew in (False, True):
                put = (lambda t: _unaligned(t.to(dev))) if skew else (lambda t: t.to(dev))
                m = None if mask is None else put(mask)
                probe = torch.zeros(kernels.H3_PROBE, dtype=torch.int64, device=dev)
                got = kernels.log_histogram_update(put(vals), put(gids), m, histogram.init(S, dev),
                                                   SPEC.min_value, lg, probe=probe).cpu()
                want = histogram.update_plain(histogram.init(S, "cpu"), gids, vals, mask)
                off = ~near if mask is None else mask & ~near
                got_off = kernels.log_histogram_update(
                    put(vals), put(gids), put(off), histogram.init(S, dev), SPEC.min_value,
                    lg).cpu()
                want_off = histogram.update_plain(histogram.init(S, "cpu"), gids, vals, off)
                what = (S, lane, dtype, mask is not None, skew)
                assert torch.equal(got_off, want_off), what
                assert int(got.sum()) == int(want.sum()), what
                ok = (gids >= 0) & (gids < S) & near & (True if mask is None else mask)
                assert int((got - want).abs().sum()) <= 2 * int(ok.sum()), what
                valid = (gids >= 0) & (gids < S) & (True if mask is None else mask)
                if lane == "global":
                    assert int(probe[0]) == int(valid.sum()), what
                else:  # one global atomic a nonzero cell a cluster: fewer than one a row
                    assert 0 < int(probe[0]) < int(valid.sum()) // 4, what


# H3's cluster lane with every row in one cell: a CTA counts at most 57,344
# rows into one u16 count (the grid grows past a wave for more rows), so
# the count stays exact; at 2^23 + 5 rows and at the last S of the lane.
@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 113])
def test_log_histogram_one_cell_on_card(S):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    assert kernels.h3_lane(S, SPEC.nbins, kernels.smem_optin_bytes(dev))[0] == "cluster"
    n = (1 << 23) + 5
    vals = torch.full((n,), 3e7, dtype=torch.float32, device=dev)
    gids = torch.full((n,), S - 1, dtype=torch.int32, device=dev)
    got = kernels.log_histogram_update(vals, gids, None, histogram.init(S, dev),
                                       SPEC.min_value, math.log(SPEC.gamma))
    want = histogram.update_plain(histogram.init(S, dev), gids, vals, None)
    assert torch.equal(got, want) and int(got.sum()) == n


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_hll_update_edges_on_card(n):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n + 1)
    optin = kernels.smem_optin_bytes(dev)
    p = hll.DEFAULT_PRECISION
    m = 1 << p
    g_max = optin // (4 * m)  # the shared lane's largest G
    assert kernels.hll_lane(g_max, p, optin) == "shared"
    assert kernels.hll_lane(g_max + 1, p, optin) != "shared"
    columns = [
        (rng.integers(0, 256, n).astype(np.uint8), 1 << 40),
        (rng.integers(0, 65536, n).astype(np.uint16), 1024),
        (rng.integers(0, 1 << 31, n).astype(np.int32), -(1 << 35)),
        (rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), None),
        (rng.integers(_I64.min, _I64.max, n, dtype=np.int64), int(_I64.max) - 5),
        (rng.normal(0, 1e6, n), None),
    ]
    for G in (1, 16, g_max, g_max + 1, 4096):
        gids = torch.from_numpy(rng.integers(-2, G + 2, n).astype(np.int32)).to(dev)
        mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        state0 = torch.from_numpy(rng.integers(0, 5, (G, m)).astype(np.int32)).to(dev)
        for unaligned in (False, True):
            g, mk = (_unaligned(gids), _unaligned(mask)) if unaligned else (gids, mask)
            for v, off in columns:
                col = torch.from_numpy(v).to(dev)
                if unaligned:
                    col = _unaligned(col)
                wide = segment.widen(segment.Narrow(col, off)) if off is not None else col
                want = hll.update_plain(state0.clone(), g, wide, mk)
                got = kernels.hll_update(col, g, mk, state0.clone(), off)
                assert torch.equal(got, want), (n, G, unaligned, str(col.dtype), off)


# H11 and H6 read their columns as staged: every row kind with offsets at
# the ends of a narrowed range and near INT64_MIN/MAX, aligned and one
# element into a buffer; H11's S on both sides of every lane's edge; H6's
# tables overflowing; bit for bit (exactly) against the plain versions.
def _minmax_edge_columns(rng, n: int) -> list:
    """(numpy values, offset) of every kind H11 reads."""
    f = rng.normal(0.0, 1e6, n)
    special = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324]
    f[: min(n, 8)] = special[: min(n, 8)]
    u8 = rng.integers(0, 256, n).astype(np.uint8)
    u8[: min(n, 2)] = [255, 0][: min(n, 2)]
    return [
        (u8, int(_I64.max) - 255),
        (rng.integers(0, 65536, n).astype(np.uint16), int(_I64.min)),
        (rng.integers(0, 1 << 31, n).astype(np.int32), int(_I64.max) - (1 << 31) + 1),
        (rng.integers(0, 1 << 31, n).astype(np.int32), -(1 << 40)),
        (rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), 0),
        (rng.random(n) < 0.5, 0),
        (rng.integers(_I64.min, _I64.max, n, dtype=np.int64), 0),
        (f, 0),
    ]


def _h11_edge_S(optin: int) -> list:
    limit = optin // 8
    assert kernels.h11_lane(limit, optin)[0] == "cluster"
    assert kernels.h11_lane(limit + 1, optin)[0] == "global"
    return [1, 2, 8, 9, 16, 33, 64, 4096, limit, limit + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_segment_minmax_edges_on_card(n):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n + 11)
    optin = kernels.smem_optin_bytes(dev)
    columns = _minmax_edge_columns(rng, n)
    for S in _h11_edge_S(optin):
        gids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32)).to(dev)
        mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        for unaligned in (False, True):
            g, mk = (_unaligned(gids), _unaligned(mask)) if unaligned else (gids, mask)
            for v, off in columns:
                col = torch.from_numpy(v).to(dev)
                if unaligned:
                    col = _unaligned(col)
                f64 = col.dtype == torch.float64
                wide = col if f64 else segment.widen(segment.Narrow(col, off))
                dtype = torch.float64 if f64 else torch.int64
                for is_min in (True, False):
                    # A state that already holds values, one group a NaN.
                    base = torch.full((S,), segment._identity_for(dtype, is_min), dtype=dtype)
                    k = base[::3].shape[0]
                    base[::3] = torch.from_numpy(
                        rng.normal(0.0, 1e6, k) if f64 else rng.integers(-(1 << 40), 1 << 40, k))
                    if f64:
                        base[S // 2] = float("nan")
                    base = base.to(dev)
                    got = kernels.segment_minmax(col, g, mk, base.clone(), is_min, off)
                    kernels.segment_minmax(col, g, mk, got, is_min, off)  # a second launch
                    want = segment.segment_minmax_plain(base.clone(), wide, g, mk, is_min)
                    assert torch.equal(got.view(torch.int64), want.view(torch.int64)), (
                        n, S, unaligned, str(col.dtype), off, is_min)
            i64 = torch.from_numpy(columns[6][0]).to(dev)
            if unaligned:
                i64 = _unaligned(i64)
            zero = torch.zeros(S, dtype=torch.int64, device=dev)
            got = kernels.segment_minmax(i64, g, None, zero.clone(), False)
            want = segment.segment_minmax_plain(zero.clone(), i64, g, None, False)
            assert torch.equal(got, want), (n, S, unaligned, "no mask")


@pytest.mark.cuda
def test_countmin_update_tables_on_card():
    """H6's tables at config 5's shape (64 keys), endpoint_load's (34
    groups x 4098 content words), overflowing (2^21 distinct words: most
    rows find no slot and add to their cells at once), narrowed columns
    with offsets, unaligned columns, more groups than the shared totals
    hold, and a width past the tables' (every row to its cells); cells
    and totals exact against the plain version."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(6)
    n = 1 << 21
    words = rng.integers(_I64.min, _I64.max, 4098, dtype=np.int64)
    cases = [
        ("config5", 16, np.array([200, 301, 404, 500])[rng.choice(4, n, p=[.85, .05, .05, .05])],
         None, countmin.DEFAULT_WIDTH),
        ("endpoint_load", 34, words[rng.integers(0, 4098, n)], None, countmin.DEFAULT_WIDTH),
        ("overflow", 16, rng.integers(_I64.min, _I64.max, n, dtype=np.int64), None,
         countmin.DEFAULT_WIDTH),
        ("uint16+off", 300, rng.integers(0, 65536, n).astype(np.uint16), -(1 << 40), 1024),
        ("int32+off", 34, rng.integers(0, 1 << 31, 70_001).astype(np.int32),
         int(_I64.max) - (1 << 31) + 1, countmin.DEFAULT_WIDTH),
        ("int32 words", 34, rng.integers(-(2**31), 2**31 - 1, 70_001).astype(np.int32), None,
         countmin.DEFAULT_WIDTH),
        ("no shared totals", 40_000, rng.integers(0, 5000, 70_001), None, 64),
        ("width 2^17", 8, rng.integers(0, 1 << 20, 70_001), None, 1 << 17),
    ]
    for name, G, v, off, width in cases:
        m = v.shape[0]
        gids = torch.from_numpy(rng.integers(-1, G + 1, m).astype(np.int32)).to(dev)
        mask = torch.from_numpy(rng.random(m) < 0.97).to(dev)
        col = torch.from_numpy(v).to(dev)
        for unaligned in (False, True):
            c, g, mk = ((_unaligned(col), _unaligned(gids), _unaligned(mask)) if unaligned
                        else (col, gids, mask))
            cm = countmin.init(G, dev, width=width)
            total = torch.zeros(G, dtype=torch.int64, device=dev)
            kernels.countmin_update(c, g, mk, cm, total, off)
            wide = segment.widen(segment.Narrow(c, off)) if off is not None else c
            ok = mk & (g >= 0) & (g < G)
            want = countmin.update_plain(countmin.init(G, dev, width=width), g, wide, mk)
            assert torch.equal(cm, want), (name, unaligned)
            assert torch.equal(total, torch.bincount(g[ok].long(), minlength=G)), (name,)


@pytest.mark.cuda
def test_histogram_kernels_match_plain_on_card():
    _need_cards(1)
    _check_histogram_kernels(torch.device("cuda", 0))


# S of the H4 launches the paths send (chip_smoke.py --log-shapes), and 4096.
H4_GROUPS = [16, 1024, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", HIST_NBINS)
@pytest.mark.parametrize("S", H4_GROUPS)
def test_hist_quantiles_edges_on_card(nbins, S):
    """H4 bit for bit with its plain version on the card at the paths'
    group counts and the edge groups (empty, all in bin 0, one bin, one
    count in the last bin, counts near 2^40, ones, a sparse row), at the
    spec's 1024 bins and at widths inside and past a warp's chunk, for the
    UDAs' 7 qs and for 40 (a second block of 32)."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    spec = histogram.LogHistogramSpec(nbins=nbins)
    state = torch.from_numpy(hist_edge_state(nbins, S, seed=S + nbins)).to(dev)
    mid = histogram.midpoint_table(spec, dev)
    for qs in (QS, QS_WIDE):
        got = kernels.hist_quantiles(state, torch.tensor(qs, dtype=torch.float64, device=dev),
                                     mid)
        want = histogram.quantile_values_plain(state, qs, spec)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (qs == QS, (got != want).nonzero()[:8].tolist())
        assert not bool(got[0].any()) and bool(torch.all(got[1] == spec.min_value))
    # an unaligned state (offset by one bin) takes the scalar loads
    wide = torch.zeros(S * nbins + 1, dtype=torch.int64, device=dev)
    wide[1:] = state.reshape(-1)
    shifted = wide[1:].view(S, nbins)
    got = kernels.hist_quantiles(shifted, torch.tensor(QS, dtype=torch.float64, device=dev), mid)
    assert torch.equal(got, histogram.quantile_values_plain(state, QS, spec))
    assert HIST_EDGE_GROUPS < S


@pytest.mark.cuda
@pytest.mark.parametrize("C", TD_CAPACITIES)
@pytest.mark.parametrize("G", [16, 300])
def test_tdigest_quantiles_edges_on_card(C, G):
    """H9 against its plain version on the card at the edge digests (empty,
    one centroid, empties between full centroids, all weight in the last,
    a total of exactly 2^24) and full ones: bit for bit where the group's
    weights are whole and total at most 2^24, within ``td_inexact_tol``
    where they are not (a total above 2^24, fractional weights, a weight
    above 2^24), at the paths' capacity and at capacities that are not a
    multiple of 256, for 7 qs and 40."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    means, weights = td_edge_state(C, G, seed=G + C)
    state = {"means": torch.from_numpy(means).to(dev),
             "weights": torch.from_numpy(weights).to(dev)}
    exact = tdigest.quantile_exact_groups(state["weights"])
    assert exact[:TD_EDGE_GROUPS].tolist() == [True] * 6 + [False] * 3
    assert bool(exact[TD_EDGE_GROUPS:].all())
    for qs in (QS, QS_WIDE):
        tol = td_inexact_tol(state["means"][~exact], state["weights"][~exact], qs)
        got = kernels.tdigest_quantiles(state["means"], state["weights"],
                                        torch.tensor(qs, dtype=torch.float32, device=dev))
        want = tdigest.quantile_values_plain(state, qs)
        torch.cuda.synchronize()
        assert torch.equal(got[exact], want[exact]), (
            (got[exact] != want[exact]).nonzero()[:8].tolist())
        assert bool(torch.all((got[~exact] - want[~exact]).abs() <= tol))
        assert not bool(got[0].any())


def join_agg_inputs(seed: int, n: int, K: int, cap: int, S_l: int, S_r: int, dev,
                    jk_dtype=np.int32, jk_offset: int = 0, gid_dtype=np.int32,
                    outside: int = 0, kept: float = 0.8):
    """H16's inputs: weights 0-5 (a zero weight is a key with no match), a
    random mask keeping ``kept`` of the rows, masked and zero-weight rows
    carrying +-inf and NaN; the keys staged as ``jk_dtype`` less
    ``jk_offset``, the gids as ``gid_dtype``; with ``outside``, keys from
    -outside to K + outside - 1 and gids up to cap + outside - 1 (a key
    outside [0, K) weighs 0)."""
    rng = np.random.default_rng(seed)
    jk = rng.integers(-outside, K + outside, n)
    gids = rng.integers(0, cap + outside, n)
    mask = rng.random(n) < kept
    n_right = rng.integers(0, 6, K).astype(np.float64)
    left = rng.exponential(3e7, (S_l, n))
    inside = (jk >= 0) & (jk < K)
    dead = ~mask | ~inside | (n_right[np.where(inside, jk, 0)] == 0)
    left[:, dead] = rng.choice([np.inf, -np.inf, np.nan], (S_l, int(dead.sum())))
    right = rng.exponential(3e7, (S_r, K))
    return [torch.from_numpy(a).to(dev) for a in (
        (jk - jk_offset).astype(jk_dtype), gids.astype(gid_dtype), mask, n_right, left, right)]


def check_join_agg_fold(ins, cap: int, jk_offset: int = 0) -> None:
    """H16 against its plain version on the same card tensors, through the
    fold's entry (``segment.join_agg_fold``: the keys a ``Narrow``, the
    left sums as columns): the count row and the effective mask exactly,
    every sum within 1e-12 * sum |terms|, one launch count a launch of
    ``kernels.join_agg_parts``, and up to 64 groups the same bits again."""
    jk, gids, mask, n_right, left, right = ins
    rows = 1 + left.shape[0] + right.shape[0]
    dev, n = jk.device, jk.shape[0]
    key = segment.Narrow(jk, jk_offset)
    cols = list(left)
    got = torch.zeros((rows, cap), dtype=torch.float64, device=dev)
    again, want, mag = torch.zeros_like(got), torch.zeros_like(got), torch.zeros_like(got)
    eff_got = torch.empty(n, dtype=torch.bool, device=dev)
    eff_want = torch.empty_like(eff_got)
    parts = kernels.join_agg_parts(rows, cap, n, kernels.sm_count(dev),
                                   kernels.smem_optin_bytes(dev))
    before = kernels.LAUNCHES["join_agg_fold"]
    segment.join_agg_fold(key, gids, mask, n_right, cols, right, got, eff_got)
    assert kernels.LAUNCHES["join_agg_fold"] == before + len(parts)
    segment.join_agg_fold(key, gids, mask, n_right, cols, right, again)
    segment.join_agg_fold_plain(key, gids, mask, n_right, left, right, want, eff_want)
    # sum |terms| per cell: the plain fold of |values| (weights are >= 0).
    segment.join_agg_fold_plain(key, gids, mask, n_right, left.abs(), right.abs(), mag)
    torch.cuda.synchronize()
    assert torch.equal(eff_got, eff_want)
    assert torch.equal(got[0], want[0])
    assert bool(torch.isfinite(got).all())
    assert bool(torch.all((got - want).abs() <= 1e-12 * mag))
    if cap <= kernels.H2_WARP_MAX_S:
        assert torch.equal(got.view(torch.int64), again.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("K,cap,S_l,S_r,jk_dtype,jk_offset,gid_dtype", [
    # join8_oncall_agg's block as staged: the private lane, statistics in shared memory
    (16, 16, 1, 1, np.uint8, 0, np.uint8),
    (16, 16, 1, 1, np.int32, 0, np.int32),  # the columns the fold widened before
    (300, 16, 1, 1, np.uint16, -1000, np.uint8),  # a narrowed key column with its offset
    (300, 64, 2, 1, np.uint16, -1000, np.uint8),  # 4 rows x 64 groups: the warp lane
    (16, 40, 3, 0, np.uint8, 0, np.uint8),  # 40 groups in the bucket of 64: the warp lane
    (16, 16, 5, 2, np.uint8, 0, np.uint8),  # 8 rows: two launches of the private lane
    (1 << 20, 1 << 16, 1, 1, np.int32, 0, np.uint16),  # both in global memory
    (1 << 20, 1 << 16, 1, 1, np.int64, 7, np.int32),  # int64 keys with an offset
    (1 << 16, 16, 2, 0, np.int32, 0, np.int32),  # private sums, statistics through __ldg
    (16, 1 << 16, 0, 2, np.uint8, 0, np.uint16),  # shared statistics, global sums
    (16, 512, 1, 1, np.uint8, 0, np.uint16),  # the shared lane
])
def test_join_agg_kernel_matches_plain_on_card(K, cap, S_l, S_r, jk_dtype, jk_offset, gid_dtype):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    ins = join_agg_inputs(K + cap, 1 << 21, K, cap, S_l, S_r, dev, jk_dtype, jk_offset, gid_dtype)
    check_join_agg_fold(ins, cap, jk_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("lane_cap", [16, 64, 512])
def test_join_agg_kernel_edges_on_card(lane_cap):
    """H16 at the edges: a row count that is no multiple of 8 (2^21 + 5 and
    13), views one element into their storage (no vector loads), keys
    outside [0, K) and gids outside [0, cap) (both add nothing), no mask, a
    probe of CTA 0's phases, and no right key at all (K 0)."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    K = 16
    gdt = np.uint8 if lane_cap < 250 else np.uint16
    for n in ((1 << 21) + 5, 13):
        for kept in (0.8, 1.0):  # with a mask, and with none (every row kept)
            # keys -2 .. K + 1 and gids up to cap + 1, one row into each storage
            jk, gids, mask, n_right, left, right = join_agg_inputs(
                n + lane_cap, n + 1, K, lane_cap, 1, 1, dev, np.uint8, -2, gdt, outside=2,
                kept=kept)
            ins = [jk[1:], gids[1:], mask[1:] if kept < 1 else None, n_right, left[:, 1:], right]
            check_join_agg_fold(ins, lane_cap, -2)
    probe = torch.zeros(kernels.JOIN_AGG_PROBE, dtype=torch.int64, device=dev)
    jk, gids, mask, n_right, left, right = join_agg_inputs(
        3, 1 << 21, K, lane_cap, 1, 1, dev, np.uint8, 0, np.uint16)
    acc = torch.zeros((3, lane_cap), dtype=torch.float64, device=dev)
    kernels.join_agg_fold(jk, gids, mask, n_right, list(left), right, acc, probe=probe)
    clocks = probe.cpu().tolist()
    assert all(b >= a for a, b in zip(clocks, clocks[1:])) and clocks[0] > 0
    empty = torch.empty(0, dtype=torch.float64, device=dev)
    eff = torch.ones(jk.shape[0], dtype=torch.bool, device=dev)
    acc.zero_()
    kernels.join_agg_fold(jk, gids, mask, empty, list(left), empty.view(1, 0), acc, eff)
    torch.cuda.synchronize()
    assert not bool(eff.any()) and not bool(acc.any())


# (S, m) of the H10 launches the paths send (chip_smoke.py --log-shapes).
H10_SHAPES = [(16, 2048), (64, 2048), (4096, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,m", H10_SHAPES + [(5, 16), (3, 1 << 14)])
@pytest.mark.parametrize("odd", [False, True])
def test_hll_estimate_matches_plain_on_card(S, m, odd):
    """H10 against its plain version on registers as updates keep them (in
    [0, 33 - p]: zero shares for linear counting, high ranks for the
    large-range correction) and, with ``odd``, one group holding a register
    above the range and one a negative register: within a relative 1e-12,
    rounded estimates equal, and every group that takes the raw estimate
    bit for bit (its f64 sum is exact in any order, and both divide
    alpha m^2 by it once)."""
    _need_cards(1)
    dev = torch.device("cuda", 0)
    p = m.bit_length() - 1
    top = 33 - p
    rng = np.random.default_rng(S + m)
    state = np.minimum(rng.geometric(0.5, (S, m)), top).astype(np.int32)
    state[rng.random((S, m)) < rng.random(S)[:, None]] = 0
    state[S // 2:] = np.maximum(state[S // 2:], rng.integers(0, top + 1, (S - S // 2, m)))
    if odd:
        state[0, 3] = top + 2
        state[-1, m - 1] = -1
    regs = torch.from_numpy(state).to(dev)
    est, rounded = kernels.hll_estimate(regs, hll._alpha(m))
    want = hll.estimate_plain(regs)
    torch.cuda.synchronize()
    torch.testing.assert_close(est, want, rtol=1e-12, atol=0)
    half = (want - torch.floor(want) - 0.5).abs() <= 1e-12 * want
    assert bool(torch.all((rounded == torch.round(want).long()) | half))
    zeros = (regs == 0).sum(dim=1)
    sums = torch.sum(torch.pow(2.0, -regs.to(torch.float64)), dim=1)
    raw = torch.full_like(sums, hll._alpha(m) * m * m) / sums
    takes_raw = ~((raw <= 2.5 * m) & (zeros > 0)) & (raw <= 2.0**32 / 30)
    if odd:
        takes_raw[0] = takes_raw[-1] = False
    assert torch.equal(est[takes_raw].view(torch.int64), want[takes_raw].view(torch.int64))


def scalar_programs(dev, n: int = 1 << 20):
    """H17's test programs over seeded columns on ``dev``: (a) int, bool
    and code work (code comparisons, a bool LUT gather, logic, int64 mod,
    bin, select, wraps) over uint8, uint16, int32, int64 and bool columns;
    (b) f64 work (divide, floor and the other casts, modulo, the
    transcendentals) over f64 and f32 columns with NaN, +-inf, +-0 and
    huge values; (c) the comparisons and float signs (a) and (b) leave out,
    a select of bools, an int add, gathers through int32, int64 and f64
    LUTs; (d) B2I, written by hand (no tree compiles to it); (e) a tree
    deep enough to use all 32 registers. Every column kind, LUT kind and
    output kind is read or written. Returns [(program, env, aux)]."""
    from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
    from pixie_tpu_torch.ops import scalar
    from pixie_tpu_torch.plan.expressions import ColumnRef as C, Constant as K, FuncCall as Fn
    from pixie_tpu_torch.types import DataType as DT, Relation
    from pixie_tpu_torch.udf.builtins import register_all
    from pixie_tpu_torch.udf.registry import Registry

    reg = Registry()
    register_all(reg)
    rng = np.random.default_rng(17)
    x = rng.uniform(-30, 30, n)
    edges = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e300, -1e300, 2.0**63, -(2.0**63), 2.5, -2.5, 5e-324]
    x[:min(n, 12)] = edges[:min(n, 12)]
    big = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    big[:min(n, 3)] = [-(2**63), 2**63 - 1, -1][:min(n, 3)]
    div = rng.choice([-7, -1, 0, 1, 5, 400], n).astype(np.int64)
    env = {
        "code": torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)),
        "u8": torch.from_numpy(rng.integers(0, 255, n).astype(np.uint8)),
        "u16": torch.from_numpy(rng.integers(0, 65535, n).astype(np.uint16)),
        "status": torch.from_numpy(rng.choice([200, 301, 404, 500], n).astype(np.int64)),
        "big": torch.from_numpy(big), "div": torch.from_numpy(div),
        "flag": torch.from_numpy(rng.random(n) < 0.5),
        "x": torch.from_numpy(x), "lat": torch.from_numpy(rng.exponential(3e7, n)),
        "f32": torch.from_numpy(rng.exponential(3e7, n).astype(np.float32)),
        "__valid__": torch.from_numpy(rng.random(n) < 0.95),
    }
    env = {k: v.to(dev) for k, v in env.items()}
    rel = Relation.of(
        ("code", DT.STRING), ("u8", DT.INT64), ("u16", DT.INT64), ("status", DT.INT64),
        ("big", DT.INT64), ("div", DT.INT64), ("flag", DT.BOOLEAN), ("x", DT.FLOAT64),
        ("lat", DT.FLOAT64), ("f32", DT.FLOAT64),
    )
    c, i, f = (lambda v: K(v, DT.STRING)), (lambda v: K(v, DT.INT64)), (lambda v: K(v, DT.FLOAT64))
    contains = Fn("contains", (C("code"), c("svc-1")))
    preds = [Fn("notEqual", (C("code"), c("a"))), Fn("notEqual", (C("code"), c("b"))),
             Fn("logical_or", (Fn("notEqual", (C("code"), c("c"))), C("flag"))), contains]
    a = {
        "failure": Fn("greaterThanEqual", (C("status"), i(400))),
        "window": Fn("bin", (Fn("multiply", (C("big"), i(3))), i(10_000_000_000))),
        "mod": Fn("modulo", (C("big"), C("div"))),
        "sel": Fn("select", (Fn("logical_not", (C("flag"),)), Fn("negate", (C("big"),)), C("u16"))),
        "narrow": Fn("subtract", (C("u8"), Fn("abs", (C("big"),)))),
        "code32": C("code"),
    }
    b = {
        "ms": Fn("floor", (Fn("divide", (C("lat"), f(1e6))),)),
        "round": Fn("round", (C("x"),)), "ceil": Fn("ceil", (C("x"),)),
        "dur": Fn("DurationNanos", (Fn("bin", (C("x"), i(5))),)),
        "modf": Fn("modulo", (C("x"), f(-2.5))), "div0": Fn("divide", (C("x"), Fn("multiply", (C("x"), f(0.0))))),
        "sqrt": Fn("sqrt", (C("lat"),)), "lin": Fn("add", (Fn("multiply", (C("x"), C("lat"))), C("f32"))),
        "log10": Fn("log10", (C("lat"),)), "ln": Fn("ln", (C("x"),)), "log2": Fn("log2", (C("f32"),)),
        "exp": Fn("exp", (C("x"),)), "pow": Fn("pow", (C("x"), f(1.7))), "logb": Fn("log", (f(3.0), C("lat"))),
        "sel": Fn("select", (Fn("greaterThanEqual", (C("status"), i(400))), C("lat"), f(0.0))),
    }
    cmp = lambda op, col, k: Fn(op, (C(col), k))
    cc = {
        "eq_i": cmp("equal", "status", i(404)), "lt_i": cmp("lessThan", "big", i(0)),
        "le_i": cmp("lessThanEqual", "u16", i(30000)), "gt_i": cmp("greaterThan", "div", i(1)),
        "eq_f": cmp("equal", "x", f(2.5)), "ne_f": cmp("notEqual", "x", f(-2.5)),
        "lt_f": cmp("lessThan", "x", f(0.0)), "le_f": cmp("lessThanEqual", "lat", f(3e7)),
        "gt_f": cmp("greaterThan", "f32", f(1e7)), "ge_f": cmp("greaterThanEqual", "x", f(-0.0)),
        "neg_f": Fn("negate", (C("x"),)), "abs_f": Fn("abs", (C("x"),)),
        "add_i": Fn("add", (C("big"), C("div"))),
        "sel_b": Fn("select", (C("flag"), cmp("lessThan", "x", f(1.0)), cmp("equal", "div", i(5)))),
        # big is loaded before: the select reads its third operand from the file.
        "sel_c": Fn("select", (cmp("greaterThan", "div", i(0)), Fn("negate", (C("div"),)), C("big"))),
    }
    luts = {"lut_i32": torch.arange(40, dtype=torch.int32) * 3 - 7,
            "lut_i64": torch.from_numpy(rng.integers(-(2**62), 2**62, 33, dtype=np.int64)),
            "lut_f64": torch.from_numpy(np.concatenate([[np.nan, -0.0], rng.normal(0, 1e9, 20)]))}
    gathers = [("g_i32", C("code"), torch.int32, "lut_i32"), ("g_i64", C("code"), None, "lut_i64"),
               ("g_f64", C("code"), None, "lut_f64")]
    deep = C("x")
    for k in range(scalar.MAX_REGS - 1):
        # Right-leaning: every product stays live until the sums close.
        deep = Fn("add", (Fn("multiply", (C("x"), f(k + 0.5))), deep))
    dicts = ["a", "b", "c"] + [f"svc-{k}" for k in range(37)]
    out = []
    dtypes = {k: v.dtype for k, v in env.items()}
    for roots, mask, extra in ((a, preds, []), (b, [], []), (cc, [], gathers), ({"deep": deep}, [], [])):
        ev = ExpressionEvaluator(list(roots.items()) + [(f"p{k}", p) for k, p in enumerate(mask)], rel, reg)
        aux = {k: v.to(dev) for k, v in luts.items()} if extra else {}
        for e in list(roots.values()) + mask:
            for key, v in ev.build_aux(e, {"code": _dictionary(dicts)}).items():
                aux[key] = torch.as_tensor(np.asarray(v)).to(dev)
        rts = [(k, e, torch.int32 if k == "code32" else None, None) for k, e in roots.items()]
        out.append((ev.compile_program(rts + extra, dtypes, aux, mask=("__valid__", mask)), env, aux))
        if extra:  # (d): B2I by hand, into an int64 output
            op = scalar.OP
            hand = scalar.ScalarProgram(
                code=[[op["LOAD"], 0, 0, 0, 0], [op["B2I"], 0, 0, 0, 0], [op["STORE"], 0, 0, 0, 0]],
                consts=[], columns=["flag"], luts=[], outputs=[("b2i", torch.int64)], n_regs=1)
            out.append((hand, env, {}))
    assert out[-1][0].n_regs == scalar.MAX_REGS
    return out


def _dictionary(values):
    from pixie_tpu_torch.table.column import StringDictionary

    d = StringDictionary()
    d.encode(np.asarray(values, dtype=object))
    return d


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    both_nan = torch.isnan(a) & torch.isnan(b)
    same = (a.view(torch.int64) == b.view(torch.int64)) | both_nan
    if bool(same.all()):
        return 0
    ai, bi = a.view(torch.int64)[~same], b.view(torch.int64)[~same]
    assert bool(((ai < 0) == (bi < 0)).all()), "sign differs"
    return int((ai - bi).abs().max())


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one element into a larger buffer, so that
    its pointer misses every vector alignment above one element."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def check_scalar_programs(dev, n: int = 1 << 20, edges: bool = False) -> dict:
    """H17 against its plain interpreter on the same card tensors at ``n``
    rows: every bool, int and f64 output bit for bit except the
    transcendentals, which agree within 2 ulp (PERF.md's H17 contract);
    returns the largest ulp gap of each transcendental output. With
    ``edges`` every column also gets a frame-of-reference offset (which
    only the int columns add) and two columns sit at unaligned pointers."""
    from pixie_tpu_torch.ops import scalar

    gaps = {}
    for prog, env, aux in scalar_programs(dev, n):
        offsets = None
        if edges:
            env = dict(env, u16=_unaligned(env["u16"]), big=_unaligned(env["big"]))
            offsets = {c: 1000 + 7 * k for k, c in enumerate(env)}
        before = kernels.LAUNCHES["scalar_eval"]
        got = prog.run(env, aux, n, raw=env if edges else None, offsets=offsets)
        assert kernels.LAUNCHES["scalar_eval"] == before + 1
        want = dict(zip([o for o, _ in prog.outputs], scalar.eval_plain(
            prog, [env[c] for c in prog.columns], [aux[k] for k in prog.luts], n,
            [offsets[c] for c in prog.columns] if offsets else None)))
        torch.cuda.synchronize()
        for name, w in want.items():
            g = got[name]
            assert g.dtype == w.dtype and g.shape == (n,), name
            if name in ("log10", "ln", "log2", "exp", "pow", "logb"):
                gaps[name] = max(gaps.get(name, 0), _ulps(g, w))
                assert gaps[name] <= 2, (name, gaps[name])
            elif g.dtype == torch.float64:
                assert _ulps(g, w) == 0, (name, n)
            else:
                assert torch.equal(g, w), (name, n)
        if "__mask__" in want and not edges:  # offsets move the codes out of the dictionary
            assert 0 < int(want["__mask__"].sum()) < n
    return gaps


@pytest.mark.cuda
def test_scalar_kernel_matches_plain_on_card():
    _need_cards(1)
    check_scalar_programs(torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 511, 513, 1023, 1025, 1 << 21])
def test_scalar_kernel_edges_on_card(n):
    """Every opcode, column, LUT and output kind, and a program at 32
    registers, at the sizes around a CTA's tile of 128 threads (128 rows at
    32 registers; 512 with an out-of-line op, 4 rows a thread; 1024 with 8)
    and at a 2^21-row block, with offsets on every column and unaligned
    columns."""
    _need_cards(1)
    check_scalar_programs(torch.device("cuda", 0), n, edges=True)


def check_codec_kernels(dev: torch.device) -> None:
    """H18 and H19 against their plain versions, bit for bit: RLE of every
    block dtype (NaN payloads and signed zeros of both float widths) over
    several shards, and delta decodes of every delta and block dtype, odd
    lengths, rows short of the shard and an empty shard, across many tiles
    (the look-back) and in one."""
    from pixie_tpu_torch.ops import codec

    rng = np.random.default_rng(18)
    for dtype in (torch.uint8, torch.uint16, torch.int32, torch.int64, torch.float32,
                  torch.float64):
        d, L, R = 3, 100_003, 4096
        ends = np.sort(rng.choice(np.arange(1, L), (d, R - 1)), axis=1).astype(np.int32)
        ends = np.concatenate([ends, np.full((d, 1), L, np.int32)], axis=1)
        ends[2, 100:] = L  # a shard with padding runs
        width = torch.empty(0, dtype=dtype).element_size()
        raw = rng.integers(0, 1 << 63, (d, R), dtype=np.uint64)
        raw[:, :3] = [0x7FF80000DEADBEEF, 1 << 63, 0x7FC0DEAD]  # NaN, -0.0; f32 NaN
        values = torch.from_numpy(raw.view(np.uint8).reshape(d, R, 8)[:, :, :width].copy()
                                  .reshape(d, R * width)).view(dtype)
        want = codec.rle_decode_plain(values, torch.from_numpy(ends),
                                      torch.empty((d, L), dtype=dtype))
        got = kernels.codec_rle_decode(values.to(dev), torch.from_numpy(ends).to(dev),
                                       torch.empty((d, L), dtype=dtype, device=dev))
        assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), dtype
    for nib, ddt in ((True, torch.uint8), (False, torch.uint8), (False, torch.uint16),
                     (False, torch.int8), (False, torch.int16), (False, torch.int32)):
        for out_dtype in (torch.uint8, torch.uint16, torch.int32, torch.int64):
            for d, L in ((3, 1_000_001), (1, 2048), (2, 7)):
                rows = torch.tensor([L, L // 2 + 1, 0][:d], dtype=torch.int32)
                bases = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, d))
                off = int(rng.integers(-(1 << 40), 1 << 40))
                if nib:
                    deltas = torch.from_numpy(rng.integers(0, 256, (d, (L + 1) // 2))
                                              .astype(np.uint8))
                else:
                    np_dt = {torch.uint8: np.uint8, torch.uint16: np.uint16,
                             torch.int8: np.int8, torch.int16: np.int16,
                             torch.int32: np.int32}[ddt]
                    info = np.iinfo(np_dt)
                    deltas = torch.from_numpy(rng.integers(info.min, info.max, (d, L))
                                              .astype(np_dt))
                want = codec.delta_decode_plain(bases, deltas, rows, off, nib,
                                                torch.empty((d, L), dtype=out_dtype))
                got = kernels.codec_delta_decode(
                    bases.to(dev), deltas.to(dev), rows.to(dev), off, nib,
                    torch.empty((d, L), dtype=out_dtype, device=dev))
                assert torch.equal(got.cpu(), want), (nib, ddt, out_dtype, d, L)


def check_cell_kernels(dev: torch.device) -> None:
    """H20 and H21 against their plain versions, exactly, at config 5's shape
    (16 groups, 4 codes) and the budget's edge (32, 256), on filled
    states."""
    rng = np.random.default_rng(20)
    for G, C in ((16, 4), (32, 256), (3, 1)):
        hist = torch.from_numpy(np.where(rng.random((G, C)) < 0.7,
                                         rng.integers(1, 1 << 20, (G, C)), 0))
        lut = torch.from_numpy(np.unique(rng.integers(-(1 << 50), 1 << 50, C + 8))[:C])
        state = torch.from_numpy(rng.integers(0, 6, (G, 2048)).astype(np.int32))
        want = hll.cell_update_plain(state, hist, lut)
        got = kernels.hll_cell_update(state.clone().to(dev), hist.to(dev), lut.to(dev))
        assert torch.equal(got.cpu(), want), (G, C)
        cm = torch.from_numpy(rng.integers(0, 9, (G, 4, 8192)))
        total = torch.from_numpy(rng.integers(0, 99, G))
        want_cm = countmin.cell_update_plain(cm, hist, lut)
        cm_d, total_d = cm.clone().to(dev), total.clone().to(dev)
        kernels.countmin_cell_update(cm_d, total_d, hist.to(dev), lut.to(dev))
        assert torch.equal(cm_d.cpu(), want_cm) and torch.equal(total_d.cpu(),
                                                                total + hist.sum(dim=1))


@pytest.mark.cuda
def test_codec_kernels_match_plain_on_card():
    _need_cards(1)
    check_codec_kernels(torch.device("cuda", 0))


def _rle_values(rng, d: int, R: int, dtype) -> torch.Tensor:
    w = torch.empty(0, dtype=dtype).element_size()
    raw = rng.integers(0, 1 << 63, (d, R), dtype=np.uint64)
    raw[0, : min(R, 3)] = [0x7FF80000DEADBEEF, 1 << 63, 0x7FC0DEAD][: min(R, 3)]
    return torch.from_numpy(raw.view(np.uint8).reshape(d, R, 8)[:, :, :w].copy()
                            .reshape(d, R * w)).view(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int32, torch.int64,
                                   torch.float32, torch.float64])
def test_rle_decode_edges_on_card(dtype):
    """H18 against its plain version, bit for bit, at its edges: one run (R
    1, its end at L and short of it), rows past the last end (run R - 1),
    runs of no rows inside a tile that overflow its staged window (rows
    past it searched in global memory), runs at the codec's short-run limit
    (2.3 rows a run), a block one element past a 16-byte boundary, shards of
    1, 7 and 4097 rows (shards that start off a boundary), and 4096 runs
    over the full 2^23-row window."""
    _need_cards(1)
    from pixie_tpu_torch.ops import codec

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(180)
    cases = []
    for d, L in ((1, 1), (3, 7), (3, 4097), (2, 100_003)):
        cases.append((np.full((d, 1), L, np.int32), L))
        cases.append((np.full((d, 1), max(L // 3, 1), np.int32), L))
    L = 100_003
    past = np.sort(rng.choice(np.arange(1, L - 500), (2, 300)), axis=1)
    cases.append((past, L))
    inside = np.sort(np.concatenate([[5] * 5000, [9000] * 7000, [L] * 3,
                                     rng.choice(np.arange(6, 9000), 100, replace=False),
                                     rng.choice(np.arange(9001, L), 400, replace=False)]))
    cases.append((inside[None], L))
    short = np.concatenate([np.sort(rng.choice(np.arange(1, L), L // 2 - 2, replace=False)),
                            [L, L]])
    cases.append((short[None], L))
    for d, L, R in ((3, 4097, 1500), (1, 1 << 23, 4096)):
        e = np.sort(rng.choice(np.arange(1, L), (d, R - 1)), axis=1)
        cases.append((np.concatenate([e, np.full((d, 1), L)], axis=1), L))
    for ends, L in cases:
        ends = torch.from_numpy(np.ascontiguousarray(ends).astype(np.int32))
        d, R = ends.shape
        values = _rle_values(rng, d, R, dtype)
        want = codec.rle_decode_plain(values, ends, torch.empty((d, L), dtype=dtype))
        got = kernels.codec_rle_decode(values.to(dev), ends.to(dev),
                                       torch.empty((d, L), dtype=dtype, device=dev))
        assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), (d, L, R)
        if d * L < 1 << 21:  # the block one element past a 16-byte boundary
            buf = torch.empty(d * L + 1, dtype=dtype, device=dev)
            out = buf[1:].view(d, L)
            kernels.codec_rle_decode(values.to(dev), ends.to(dev), out)
            assert torch.equal(out.cpu().view(torch.uint8), want.view(torch.uint8)), (d, L, R)
    probe = torch.zeros(kernels.RLE_PROBE, dtype=torch.int64, device=dev)
    kernels.codec_rle_decode(values.to(dev), ends.to(dev),
                             torch.empty((d, L), dtype=dtype, device=dev), probe=probe)
    stamps = probe.cpu().tolist()
    assert all(0 < x <= y for x, y in zip(stamps, stamps[1:])), stamps


_F64_EDGES = np.array([
    0x7FF8000000000000, 0xFFF8000000000000, 0x7FF80000DEADBEEF, 0x7FF4000000000001,
    0x7FF0000000000000, 0xFFF0000000000000, 0x0000000000000000, 0x8000000000000000,
    0x36A0000000000000, 0xB6A8000000000000, 0x380FFFFFFFFFFFFF, 0x47EFFFFFF0000000,
    0x4800000000000000, 0x0000000000000001,
], dtype=np.uint64)


def check_convert_kernel(dev: torch.device) -> None:
    """H24 against ``convert_block_plain``, bit for bit, for every (kind,
    source, destination) pair it admits: odd lengths, a slice of a larger
    staging as ``out``, f64 edges (NaN payloads of both signs, +-inf, +-0,
    f32 subnormals, overflow) and LUTs of 1, 3, 256, 6144 (the largest in
    shared memory), 6145 and 65536 entries."""
    from pixie_tpu_torch.ops import codec

    rng = np.random.default_rng(24)
    n = 1_000_003

    def src_of(dtype):
        if dtype == torch.bool:
            return torch.from_numpy(rng.random(n) < 0.5)
        if dtype == torch.float64:
            x = rng.exponential(3e7, n) * rng.choice([-1.0, 1.0], n)
            x[: _F64_EDGES.size] = _F64_EDGES.view(np.float64)
            return torch.from_numpy(x)
        big = 1 << 62 if dtype == torch.int64 else 1 << 30
        return torch.from_numpy(rng.integers(-big, big, n)).to(dtype)

    np_dt = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.int32: np.int32,
             torch.int64: np.int64, torch.float32: np.float32, torch.bool: np.bool_}
    for kind, pairs in kernels.CONVERT_PAIRS.items():
        if kind == "intdict":
            continue
        for src_dt, dst_dt in sorted(pairs, key=str):
            x = src_of(src_dt)
            if kind == "narrow":
                plan = ("narrow", (np.dtype(np_dt[dst_dt]), -12345))
            elif kind == "f32":
                plan = ("f32", None)
            else:
                plan = ("raw", None)
            int_dtype = np.dtype(np.float64) if dst_dt == torch.float64 else np.dtype(np_dt[dst_dt])
            want = codec.convert_block(plan, x, int_dtype=int_dtype)
            staged = torch.zeros(n + 100, dtype=dst_dt, device=dev)
            got = codec.convert_block(plan, x.to(dev), out=staged[50 : 50 + n], int_dtype=int_dtype)
            assert got.data_ptr() == staged[50:].data_ptr()
            assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), (
                kind, src_dt, dst_dt)
            edges = staged.cpu().view(torch.uint8)  # torch has no any() of uint16
            es = staged.element_size()
            assert not edges[: 50 * es].any() and not edges[-50 * es :].any()
    for C in (1, 3, 256, 6144, 6145, 1 << 16):
        lut = np.unique(rng.integers(-(1 << 50), 1 << 50, C + 100))[:C].astype(np.int64)
        x = torch.from_numpy(np.concatenate([lut[rng.integers(0, C, n - 4)],
                                             [lut[0] - 1, lut[-1] + 1, -(1 << 63), (1 << 63) - 1]]))
        for dst_dt in (torch.uint8, torch.uint16, torch.int32):
            plan = ("intdict", (lut, np.dtype(np_dt[dst_dt])))
            want = codec.convert_block(plan, x)
            got = codec.convert_block(plan, x.to(dev))
            assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), (C, dst_dt)


@pytest.mark.cuda
def test_convert_kernel_matches_plain_on_card():
    _need_cards(1)
    check_convert_kernel(torch.device("cuda", 0))


def check_convert_shards(dev: torch.device, d: int) -> None:
    """H24's shard-stride lane: one ring window of ``d`` logical shards
    ([d, nblk, b], 2^18 rows a shard) converted in one launch into its
    slice of a one-card staging of three windows, bit for bit the plain
    version on the same strided slice, for every case of RING_CASES; the
    staging's other windows keep their bytes."""
    from pixie_tpu_torch.ops import codec
    from pixie_tpu_torch.ops.convert_edges import RING_CASES, ring_case, strided_staging

    rng = np.random.default_rng(40 + d)
    nblk, b = 2, 1 << 17
    for name in RING_CASES:
        raw, col_plan, dt, _off = ring_case(name, rng, d * nblk * b)
        x = torch.from_numpy(raw.reshape(d, nblk, b))
        int_dtype = dt if col_plan[0] == "raw" else None
        tdt = codec.TORCH_DTYPES[dt]
        want_all, want = strided_staging(d, nblk, b, tdt, "cpu")
        codec.convert_block_plain(col_plan, x, want)
        got_all, got = strided_staging(d, nblk, b, tdt, dev)
        before = dict(kernels.LAUNCHES)
        codec.convert_block(col_plan, x.to(dev), out=got, int_dtype=int_dtype)
        assert kernels.LAUNCHES["ring_convert"] == before.get("ring_convert", 0) + 1, name
        assert got.stride(0) == 3 * nblk * b
        assert torch.equal(got_all.cpu().view(torch.uint8), want_all.view(torch.uint8)), (name, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4, 8])
def test_convert_shard_stride_matches_plain_on_card(d):
    _need_cards(1)
    check_convert_shards(torch.device("cuda", 0), d)


@pytest.mark.cuda
@pytest.mark.parametrize("cards,spec", [(2, "d:2"), (4, "hosts:2,d:2")])
def test_ring_over_cards_equals_logical_shards(cards, spec):
    """A resident ring sharded over ``cards`` real cards (each window's
    shard s on card s, converted by one H24 launch a card) serves every
    full window and equals the same ring over logical shards of cuda:0:
    a head(n) scan's rows and an aggregate's outputs exactly. With no
    device named, the executor spans every card."""
    _need_cards(cards)
    from pixie_tpu_torch.distributed import MeshConfig
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor, staging
    from pixie_tpu_torch.types import DataType, Relation
    from pixie_tpu_torch.utils import flags

    assert DeviceExecutor().mesh.size == torch.cuda.device_count()
    rng = np.random.default_rng(25)
    n, window = 300_000, 1 << 16
    data = {"service": np.array([f"svc-{i}" for i in rng.integers(0, 12, n)], dtype=object),
            "status": rng.choice([200, 404, 500], n), "lat": rng.exponential(3e7, n)}
    rel = Relation.of(("service", DataType.STRING), ("status", DataType.INT64),
                      ("lat", DataType.FLOAT64))
    queries = {
        "scan": "df = px.DataFrame(table='t')\ndf = df[df.status >= 400]\n"
                "df = df.head(5000)\npx.display(df, 'out')\n",
        "agg": "df = px.DataFrame(table='t')\ng = df.groupby('service').agg("
               "n=('lat', px.count), hi=('lat', px.max), cm=('status', px.count_min))\n"
               "px.display(g, 'out')\n",
    }
    outs = []
    for devices in (["cuda:0"] * cards, [f"cuda:{i}" for i in range(cards)]):
        flags.set("resident_ingest", True)
        flags.set("resident_window_rows", window)
        try:
            ex = DeviceExecutor(block_rows=1 << 14, mesh_config=MeshConfig.parse(spec, cards),
                                devices=devices)
            c = Carnot(device_executor=ex)
            t = c.table_store.create_table("t", rel)
            for off in range(0, n, 50_000):
                t.write_pydict({k: v[off : off + 50_000] for k, v in data.items()})
            ring = ex._resident.ring_for("t")
            assert ring.snapshot()["windows"] == n // window and ring.d == cards
            lanes = [b for w in ring.windows.values() for b in w.blocks.values()]
            assert all(isinstance(b, staging.ShardedBlocks) == (devices[0] != devices[-1])
                       for b in lanes)
            got = {}
            for name, q in queries.items():
                staging.reset_cold_profile()
                kernels.reset_launches()
                got[name] = c.execute_query(q).table("out")
                assert staging.reset_cold_profile().get("stage_resident_hits") == n // window
                assert kernels.LAUNCHES["ring_convert"] > 0
            outs.append(got)
        finally:
            flags.reset("resident_ingest")
            flags.reset("resident_window_rows")
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_cell_kernels_match_plain_on_card():
    _need_cards(1)
    check_cell_kernels(torch.device("cuda", 0))


def _pred_columns(n: int):
    """Term columns as the batched fold stages them: a narrowed uint16
    status with its offset, f64 latency with NaN and signed zeros, int32
    codes (-1 included), f32 and bool blocks."""
    rng = np.random.default_rng(21)
    status = rng.choice([200, 301, 404, 500], n).astype(np.int64)
    lat = rng.exponential(3e7, n)
    lat[:4] = [np.nan, 0.0, -0.0, 2e7]
    cols = {
        "status": (torch.from_numpy((status - 200).astype(np.uint16)), 200),
        "latency": (torch.from_numpy(lat), 0),
        "codes": (torch.from_numpy(rng.integers(-1, 4000, n).astype(np.int32)), 0),
        "l32": (torch.from_numpy(lat.astype(np.float32)), 0),
        "ok": (torch.from_numpy(rng.random(n) < 0.5), 0),
    }
    return cols, {c: t.numpy().dtype for c, (t, _) in cols.items()}


def _slot_terms(B: int) -> list:
    fams = [
        [("i", "status", 0, 200, 0.0, ())], [("i", "status", 1, 200, 0.0, ())],
        [("f", "latency", 4, 0, 2e7, ())], [("i", "status", 6, 0, 0.0, (200, 404))],
        [("f", "latency", 1, 0, -0.0, ()), ("i", "ok", 1, 0, 0.0, ())],
        [("i", "codes", 6, 0, 0.0, tuple(range(-1, 2047, 2)))],  # 1024 members
        [("f", "l32", 2, 0, float(np.float64(np.float32(1e7))), ())],
        [],
    ]
    return [fams[s % len(fams)] + ([("i", "status", 5, 200 + s, 0.0, ())] if s >= 8 else [])
            for s in range(B)]


def check_batch_kernels(dev: torch.device) -> None:
    n = 1 << 18
    cols, dtypes = _pred_columns(n)
    base = torch.from_numpy(np.random.default_rng(22).random(n) < 0.9)
    for B in (1, 7, 16, 32):
        table = batched.build_term_table(_slot_terms(B), dtypes)
        args = ([cols[c][0] for c in table.columns], [cols[c][1] for c in table.columns])
        want = batched.slot_masks_plain(*args, base, table)
        got = batched.slot_masks([t.to(dev) for t in args[0]], args[1], base.to(dev),
                                 table.to(dev))
        assert got.device == dev and torch.equal(got.cpu(), want), B
    rng = np.random.default_rng(23)
    bits = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    irows = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, (2, n), dtype=np.int64))
    frows = torch.from_numpy(rng.exponential(3e7, (2, n)))
    optin = kernels.smem_optin_bytes(dev)
    # the slot lane, shared partials, then the global path
    for B, S, lane in ((2, 16, "slots"), (8, 64, "slots"), (16, 16, "shared"),
                       (32, 4096, "global")):
        assert kernels.h23_lane(B, 2, 2, S, optin)[0] == lane
        gids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32))
        want_i, want_f = batched.batched_segment_sums_plain(irows, frows, gids, bits, B, S)
        got_i, got_f = batched.batched_segment_sums(
            irows.to(dev), frows.to(dev), gids.to(dev), bits.to(dev), B, S)
        assert torch.equal(got_i.cpu(), want_i)
        _, abs_f = batched.batched_segment_sums_plain(irows, frows.abs(), gids, bits, B, S)
        assert torch.all((got_f.cpu() - want_f).abs() <= 1e-12 * abs_f)
        if lane == "slots":  # the same bits every run
            again = batched.batched_segment_sums(
                irows.to(dev), frows.to(dev), gids.to(dev), bits.to(dev), B, S)[1]
            assert bits_equal(again, got_f)


def h23_staged_rows(rng, n: int, dev, unaligned: bool) -> tuple:
    """H23's rows as the fold stages them: integer rows uint8, uint16 and
    int32 with offsets, int64 and bool; f64 rows f64, a narrowed int32 and
    a bool; each a view one row into its buffer when ``unaligned``."""
    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a).to(dev)
        return _unaligned(t) if unaligned else t
    i32 = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    flag = rng.random(n) < 0.3
    lat = rng.exponential(3e7, n)
    lat[: min(n, 3)] = [np.nan, -0.0, 1e-300][: min(n, 3)]
    irows = [segment.Narrow(put(rng.integers(0, 256, n).astype(np.uint8)), 200),
             segment.Narrow(put(rng.integers(0, 65536, n).astype(np.uint16)), -(2**40)),
             segment.Narrow(put(i32), 2**62), put(rng.integers(-(2**62), 2**62, n)), put(flag)]
    frows = [put(lat), segment.Narrow(put(i32), 1000), put(flag)]
    return irows, frows


# H23 at its edges: rows as staged (every kind, offsets, views one row into
# their buffers), n on and off the 8-row vectors, B 1 to 32, S at each lane
# boundary; integers and presence exact, f64 sums within 1e-12 * sum |v|
# (NaN where the plain version has NaN), the slot lane the same bits twice.
@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_batched_segment_sums_edges_on_card(n):
    _need_cards(1)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n)
    optin = kernels.smem_optin_bytes(dev)
    for B, S in ((1, 1), (2, 16), (7, 16), (32, 64), (3, 65), (32, 256), (32, 4096)):
        gids = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32)).to(dev)
        bits = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32)).to(dev)
        for unaligned in (False, True):
            irows, frows = h23_staged_rows(rng, n, dev, unaligned)
            for ir, fr in ((irows, frows), (irows[:1], []), ([], frows[:1]), ([], [])):
                got_i, got_f = batched.batched_segment_sums(ir, fr, gids, bits, B, S)
                want_i, want_f = batched.batched_segment_sums_plain(ir, fr, gids, bits, B, S)
                what = (B, S, unaligned, len(ir), len(fr),
                        kernels.h23_lane(B, len(ir), len(fr), S, optin)[0])
                assert torch.equal(got_i, want_i), what
                absr = [segment.widen(r).to(torch.float64).abs() for r in fr]
                scale = batched.batched_segment_sums_plain([], absr, gids, bits, B, S)[1]
                nan = torch.isnan(want_f)
                assert torch.equal(torch.isnan(got_f), nan), what
                assert bool(torch.all((got_f - want_f).abs()[~nan] <= 1e-12 * scale[~nan])), what
                again = batched.batched_segment_sums(ir, fr, gids, bits, B, S)
                assert torch.equal(again[0], got_i), what
                if what[-1] == "slots":
                    assert bits_equal(again[1], got_f), what


def _h22_cases(n: int) -> list:
    """(name, columns {name: (CPU tensor, offset)}, slot terms) of H22's
    card cases: _slot_terms at B 1, 7, 16 and 32, the soak's B 7 and
    wide_terms 16 and 32 on the staged status and latency, SLOT_CASES on
    the edge columns, 16 columns of every dtype, and op-6 lists of every
    form (ops/pred_edges.py)."""
    cols, _ = _pred_columns(n)
    rng = np.random.default_rng(24)
    i64 = rng.integers(-(1 << 16), 1 << 16, n)
    i64[:6] = [pred_edges.INT64_MIN, pred_edges.INT64_MAX, pred_edges.INT64_MIN + 7, 0, -1,
               (1 << 15) - 1]
    cols["i64"] = (torch.from_numpy(i64), 0)
    many = {c: (torch.from_numpy(a), o) for c, (a, o) in pred_edges.sixteen_columns(n).items()}
    edge = {c: (torch.from_numpy(a), o) for c, (a, o) in pred_edges.edge_columns(n).items()}
    cases = [(f"slot_terms B={B}", cols, _slot_terms(B)) for B in (1, 7, 16, 32)]
    cases.append(("soak B=7", cols, pred_edges.soak_terms("status", "latency")))
    cases += [(f"wide_terms({B})", cols, pred_edges.wide_terms(B, "status", "latency"))
              for B in (16, 32)]
    cases += [(f"SLOT_CASES[{i}]", edge, st) for i, st in enumerate(pred_edges.SLOT_CASES)]
    cases.append(("sixteen columns", many, pred_edges.sixteen_terms()))
    cases.append(("lists", cols, pred_edges.lists_terms()))
    return cases


# H22 at the soak's and the wide batches' shapes and its edges: a 2^21-row
# block and its 8-row tail (n = 2^21 + 3), every column, the mask and the
# output aligned and every column and the mask one element into its buffer
# (no vector loads); bit for bit against the plain version.
@pytest.mark.cuda
def test_pred_slot_masks_shapes_on_card():
    _need_cards(1)
    dev = torch.device("cuda", 0)
    n = (1 << 21) + 3
    base = torch.from_numpy(np.random.default_rng(25).random(n) < 0.9)
    for name, cols, slot_terms in _h22_cases(n):
        table = batched.build_term_table(
            slot_terms, {c: t.numpy().dtype for c, (t, _) in cols.items()})
        tcols = [cols[c][0] for c in table.columns]
        offs = [cols[c][1] for c in table.columns]
        want = batched.slot_masks_plain(tcols, offs, base, table)
        dtable = table.to(dev)
        for unaligned in (False, True):
            put = (lambda t: _unaligned(t.to(dev))) if unaligned else (lambda t: t.to(dev))
            got = batched.slot_masks([put(t) for t in tcols], offs, put(base), dtable)
            assert got.device == dev and torch.equal(got.cpu(), want), (name, unaligned)


@pytest.mark.cuda
def test_batch_kernels_match_plain_on_card():
    _need_cards(1)
    check_batch_kernels(torch.device("cuda", 0))


def check_ml_kernels(dev: torch.device) -> None:
    """H25 and H26 against their plain versions bit for bit (int64 and f64
    blocks with NaN, +-0, masks and a salt near 2^40; an empty and a full
    state; 16 and 4096 groups; a merge with forced ties), H27 within 1e-5."""
    rng = np.random.default_rng(30)
    n = 1 << 16
    for dtype in (torch.int64, torch.float64):
        if dtype == torch.int64:
            v = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64))
        else:
            x = rng.normal(0, 1e6, n)
            x[:4] = [np.nan, 0.0, -0.0, np.inf]
            v = torch.from_numpy(x)
        mask = torch.from_numpy(rng.random(n) < 0.8)
        salt = (1 << 40) + 3
        want = ml.priorities_plain(v, salt, mask)
        got = ml.priorities(v.to(dev), salt, mask.to(dev))
        assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
        for G in (16, 4096):
            st = ml.reservoir_init(G, "cpu", dtype=dtype)
            st_dev = ml.reservoir_init(G, dev, dtype=dtype)
            for _ in range(3):  # empty, then fuller states
                gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32))
                st = ml.update_plain(st, gids, v, mask)
                st_dev = ml.reservoir_update(st_dev, gids.to(dev), v.to(dev), mask.to(dev))
                for key in st:
                    a, b = st_dev[key].cpu(), st[key]
                    assert torch.equal(a.view(torch.int64) if a.dtype == torch.float64 else a,
                                       b.view(torch.int64) if b.dtype == torch.float64 else b)
    pri = torch.tensor([[0.5, 0.5, 0.25, -np.inf], [0.75, 0.5, 0.5, 0.5]], dtype=torch.float64)
    vals = torch.arange(8, dtype=torch.float64).reshape(2, 4)
    a = {"values": vals, "priority": pri, "count": torch.tensor([3, 4])}
    b = {"values": 100 + vals, "priority": pri.sort(dim=1, descending=True).values,
         "count": torch.tensor([3, 4])}
    want = ml.reservoir_merge(a, b)
    got = ml.reservoir_merge({k: t.to(dev) for k, t in a.items()},
                             {k: t.to(dev) for k, t in b.items()})
    for key in want:
        assert torch.equal(got[key].cpu(), want[key])
    pts = torch.from_numpy(rng.normal(0, 1, (16, 128, 64)).astype(np.float32))
    pts[:, 64:] = pts[:, :64]  # duplicated points: the first-index ties
    w = torch.from_numpy((rng.random((16, 128)) < 0.9).astype(np.float32))
    for k in (4, 8):
        want = ml.kmeans_fit_plain(pts, w, k)
        got = ml.kmeans_fit(pts.to(dev), w.to(dev), k).cpu()
        assert (got - want).abs().max() <= 1e-5


def _same_nan_close(got: torch.Tensor, want: torch.Tensor, what) -> None:
    """The same NaN pattern; elsewhere equal (infinities) or within 1e-5."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert bool(((got == want) | ((got - want).abs() <= 1e-5))[~nan].all()), what


# H27 where NaN and infinities reach it (a JSON embedding may hold them):
# the same NaN pattern as the plain version (a NaN distance wins the
# minimum, the argmax and the argmin as the first NaN; 0 * NaN and 0 * inf
# make a center's sum NaN) and 1e-5 elsewhere, every point dead, k above
# S; exact copies on the tie groups (the first index); and the main path's
# shape with NaN in a live and in a dead point.
@pytest.mark.cuda
def test_kmeans_fit_nan_inf_and_ties_on_card():
    _need_cards(1)
    dev = torch.device("cuda", 0)
    pts, w = (torch.from_numpy(a) for a in kmeans_edges.nan_groups())
    for k in (3, 4, 8, 20):
        want = ml.kmeans_fit_plain(pts, w, k)
        got = ml.kmeans_fit(pts.to(dev), w.to(dev), k).cpu()
        _same_nan_close(got, want, ("nan groups", k))
    tpts, tw = (torch.from_numpy(a) for a in kmeans_edges.tie_groups())
    for k in (2, 3, 4):
        assert torch.equal(ml.kmeans_fit(tpts.to(dev), tw.to(dev), k).cpu(),
                           ml.kmeans_fit_plain(tpts, tw, k)), ("ties", k)
    rng = np.random.default_rng(26)
    big = torch.from_numpy(rng.normal(0, 3, (16, 128, 64)).astype(np.float32))
    bw = torch.from_numpy((rng.random((16, 128)) < 0.9).astype(np.float32))
    big[3, 40, 7], bw[3, 40] = float("nan"), 1.0
    big[5, 9, 63], bw[5, 9] = float("nan"), 0.0
    big[7, 2, 0], bw[7, 2] = float("inf"), 1.0
    for k in (4, 8):
        _same_nan_close(ml.kmeans_fit(big.to(dev), bw.to(dev), k).cpu(),
                        ml.kmeans_fit_plain(big, bw, k), ("G 16 S 128 d 64", k))


def encoder_batches(rng) -> list:
    """(ids, lens) int32 CPU batches for H28: one document of 1 and of 64
    tokens (B = 1), every length 1..64 in one batch (tile boundaries fall
    inside documents), lengths 0 and 70 (clamped into 0..64) among others,
    and 4098 documents of 1, 17 or 64 tokens (path_embeddings' count)."""
    lens_sets = [np.array([1]), np.array([64]), rng.permutation(np.arange(1, 65)),
                 np.array([5, 0, 64, 70, 1, 0, 33]), rng.choice([1, 17, 64], 4098)]
    out = []
    for lens in lens_sets:
        lens = torch.from_numpy(lens.astype(np.int32))
        ids = torch.from_numpy(rng.integers(1, transformer.VOCAB, (lens.shape[0], 64)).astype(np.int32))
        ids[torch.arange(64)[None, :] >= lens[:, None]] = 0
        out.append((ids, lens))
    return out


def check_encoder_kernel(dev: torch.device) -> None:
    """H28 against its plain version (on the CPU) within 1e-5 on every
    batch of ``encoder_batches``, one launch a batch."""
    assert not torch.backends.cuda.matmul.allow_tf32
    params = transformer._init_params(0)
    cpu, card = (transformer.TransformerEncoder(params, d) for d in ("cpu", dev))
    for ids, lens in encoder_batches(np.random.default_rng(31)):
        want = cpu(ids, lens)
        before = kernels.LAUNCHES["encoder_forward"]
        got = card(ids.to(dev), lens.to(dev)).cpu()
        assert kernels.LAUNCHES["encoder_forward"] == before + 1
        err = float((got - want).abs().max())
        assert err <= 1e-5, (ids.shape[0], err)


def topk_edge_cases(rng, n: int = 1 << 21):
    """H26's edge shapes: (name, G, k, gids with G for masked rows, row
    priorities, row values as int64 bits, whether the state is full, the
    state's priorities on a grid of 8 values)."""
    mask = rng.random(n) < 0.7
    words = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    for name, G, k, layout in (("G1", 1, 64, "spread"), ("G16", 16, 64, "spread"),
                               ("G4096", 4096, 64, "spread"), ("one_group", 16, 64, "one"),
                               ("empty_groups", 16, 64, "even"), ("k1", 16, 1, "spread"),
                               ("k768", 16, 768, "spread"), ("k768_G4096", 4096, 768, "spread"),
                               ("G64_k16", 64, 16, "spread")):
        gids = rng.integers(0, G, n)
        if layout == "one":
            gids[:] = 5
        elif layout == "even":
            gids = 2 * rng.integers(0, G // 2, n)  # the odd groups get no rows
        for ties in (False, True):
            pri = np.floor(rng.random(n) * 8) / 8 if ties else rng.random(n)
            pri = np.where(mask, pri, -np.inf)
            for full in (False, True):
                yield (f"{name}{'_ties' if ties else ''}{'_full' if full else ''}", G, k,
                       np.where(mask, gids, G), pri, words, full)


def topk_state(rng, G: int, k: int, full: bool, ties: bool) -> dict:
    st = ml.reservoir_init(G, "cpu", k=k)
    if full:
        p = np.floor(rng.random((G, k)) * 8) / 8 if ties else rng.random((G, k))
        st["priority"] = torch.from_numpy(-np.sort(-p, axis=1))
        st["values"] = torch.from_numpy(rng.normal(0, 1, (G, k)))
    return st


def check_topk_edges(dev: torch.device) -> None:
    """H26 bit for bit against ``topk_rows_plain`` (both on the card) at
    2^21 rows: 1, 16, 64 and 4096 groups, one group holding every row, empty
    groups, k 1, 16, 64 and 768, ties on a grid of 8 priorities, empty and
    full states, through the bucketed entry and, where it fits, the
    sort-free one (counts too); then the merge shapes: ``reservoir_merge`` of 16 and 4096
    reservoirs and a TREE merge of four shards' states in device order."""
    rng = np.random.default_rng(26)
    for name, G, k, g, pri, words, full in topk_edge_cases(rng):
        st = {key: t.to(dev) for key, t in topk_state(rng, G, k, full, "ties" in name).items()}
        g_d, pri_d = torch.from_numpy(g).to(dev), torch.from_numpy(pri).to(dev)
        w_d = torch.from_numpy(words).to(dev)
        order, offsets = ml.bucket_rows(g_d, G)
        vk, pk = kernels.reservoir_topk(st["values"].view(torch.int64), st["priority"], w_d,
                                        pri_d, order, offsets)
        want = ml.topk_rows_plain(st, g_d, pri_d, w_d.view(torch.float64))
        assert torch.equal(vk, want["values"].view(torch.int64)), name
        assert torch.equal(pk.view(torch.int64), want["priority"].view(torch.int64)), name
        if kernels.topk_rows_fits(G, k):  # the sort-free entry, counted under its own name
            counts = kernels.LAUNCHES["reservoir_topk_rows"], kernels.LAUNCHES["reservoir_topk"]
            vr, pr, cr = kernels.reservoir_topk_rows(
                st["values"].view(torch.int64), st["priority"], st["count"], w_d, pri_d,
                g_d.to(torch.int32))
            assert (kernels.LAUNCHES["reservoir_topk_rows"],
                    kernels.LAUNCHES["reservoir_topk"]) == (counts[0] + 1, counts[1]), name
            assert torch.equal(vr, want["values"].view(torch.int64)), name
            assert torch.equal(pr.view(torch.int64), want["priority"].view(torch.int64)), name
            assert torch.equal(cr, want["count"]), name
    for G in (16, 4096):
        shards = [{key: t.to(dev) for key, t in topk_state(rng, G, 64, True, ties).items()}
                  for ties in (True, True, False, True)]
        acc, acc_plain = shards[0], shards[0]
        for b in shards[1:]:  # the TREE merge's order: acc = merge(acc, g[i])
            acc = ml.reservoir_merge(acc, b)
            acc_plain = ml.reservoir_merge_plain(acc_plain, b)
            for key in acc:
                assert torch.equal(acc[key], acc_plain[key]), (G, key)


def check_delta_edges(dev: torch.device) -> None:
    """H19 bit for bit against ``delta_decode_plain`` over 3 shards of L =
    1, 7 and 1,000,001 rows, rows on its 4096-row tile edges and one off
    them, nibbles and int16 deltas into int64 and uint8 blocks."""
    from pixie_tpu_torch.ops import codec

    rng = np.random.default_rng(19)
    tile = kernels.DELTA_TILE_ROWS
    for L, rows in ((1, (1, 0, 1)), (7, (7, 6, 1)), (1_000_001, (100 * tile, 100 * tile + 1,
                                                                   100 * tile - 1)),
                    (1_000_001, (1_000_001, tile, tile - 1)),
                    (3 * tile, (3 * tile, 2 * tile, 2 * tile + 1))):
        rows_t = torch.tensor(rows, dtype=torch.int32)
        bases = torch.tensor([2**63 - 5000, -(2**63) + 3, 12345], dtype=torch.int64)
        for nib in (True, False):
            deltas = (torch.from_numpy(rng.integers(0, 256, (3, (L + 1) // 2)).astype(np.uint8))
                      if nib else torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (3, L))
                                                   .astype(np.int16)))
            for off in ((1 << 40) - 5, -(1 << 40) + 3):
                for out_dtype in (torch.int64, torch.uint8):
                    want = codec.delta_decode_plain(bases, deltas, rows_t, off, nib,
                                                    torch.empty((3, L), dtype=out_dtype))
                    got = kernels.codec_delta_decode(
                        bases.to(dev), deltas.to(dev), rows_t.to(dev), off, nib,
                        torch.empty((3, L), dtype=out_dtype, device=dev))
                    assert torch.equal(got.cpu(), want), (L, rows, nib, off, out_dtype)


@pytest.mark.cuda
def test_reservoir_topk_edges_on_card():
    _need_cards(1)
    check_topk_edges(torch.device("cuda", 0))


@pytest.mark.cuda
def test_delta_decode_edges_on_card():
    _need_cards(1)
    check_delta_edges(torch.device("cuda", 0))


@pytest.mark.cuda
def test_ml_kernels_match_plain_on_card():
    _need_cards(1)
    check_ml_kernels(torch.device("cuda", 0))


@pytest.mark.cuda
def test_encoder_kernel_matches_plain_on_card():
    _need_cards(1)
    check_encoder_kernel(torch.device("cuda", 0))


@pytest.mark.cuda
def test_kernels_run_on_their_tensors_card():
    """With card 0 current, kernels given tensors on card 1 run there."""
    _need_cards(2)
    torch.cuda.set_device(0)
    _check_segment_kernels(torch.device("cuda:1"))
    _check_histogram_kernels(torch.device("cuda:1"))
    _check_sketch_kernels(torch.device("cuda:1"))
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_device_executor_on_second_card():
    """service_stats through DeviceExecutor(device="cuda:1") equals the
    plain path on the CPU: groups, order and counts exact, error_rate
    within 1e-12, quantiles equal or one bin apart."""
    _need_cards(2)
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.interop import table_from_columns
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.types import DataType, Relation

    rng = np.random.default_rng(5)
    n = 60_000
    cols = {
        "service": np.array([f"svc-{i}" for i in rng.integers(0, 16, n)], dtype=object),
        "resp_status": rng.choice([200, 301, 404, 500], n, p=[0.85, 0.05, 0.05, 0.05]),
        "latency": rng.exponential(3e7, n),
    }
    rel = Relation.of(
        ("service", DataType.STRING),
        ("resp_status", DataType.INT64),
        ("latency", DataType.FLOAT64),
    )
    pxl = (
        "df = px.DataFrame(table='t')\n"
        "df.failure = df.resp_status >= 400\n"
        "s = df.groupby(['service']).agg(throughput=('resp_status', px.count),\n"
        "    error_rate=('failure', px.mean), latency=('latency', px.quantiles))\n"
        "px.display(s, 'o')\n"
    )
    torch.cuda.set_device(0)
    out = {}
    for device in ("cuda:1", "cpu"):
        carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=1 << 14))
        table_from_columns(carnot.table_store, "t", rel, cols)
        kernels.reset_launches()
        out[device] = carnot.execute_query(pxl).table("o")
        if device == "cuda:1":
            # service_stats' kernels, as chip_smoke.py checks them: the
            # mean of the bool predicate rides H1's launch, so no H2.
            assert all(kernels.LAUNCHES[k] > 0 for k in (
                "segment_rows_sum_i64", "log_histogram_update", "hist_quantiles", "scalar_eval"))
            assert kernels.LAUNCHES["segment_rows_sum_f64"] == 0
    got, want = out["cuda:1"], out["cpu"]
    assert got["service"] == want["service"]
    assert got["throughput"] == want["throughput"]
    np.testing.assert_allclose(got["error_rate"], want["error_rate"], rtol=0, atol=1e-12)
    for gq, wq in zip(got["latency"], want["latency"]):
        g, w = json.loads(gq), json.loads(wq)
        for k in w:
            assert g[k] == w[k] or max(g[k], w[k]) / min(g[k], w[k]) <= SPEC.gamma * (1 + 1e-9)
    assert torch.cuda.current_device() == 0


def _merge_stack(rng, D: int, L: int, dtype, kind: str, dev) -> torch.Tensor:
    """[D, L] shard leaves of one H29 lane: the last shard empty (the
    identity of ``kind``); f64 with NaN, disagreeing signed zeros, a NaN
    payload, infinities and subnormals; int64 sums that overflow."""
    if dtype == torch.float64:
        a = rng.standard_normal((D, L)) * 1e3
        a[0, 0], a[1, 1] = np.nan, np.nan
        a[:, 2], a[0, 2] = 0.0, -0.0
        a[:, 3], a[1, 3] = -0.0, 0.0
        a[0, 4] = np.array([0x7FF8000000000001], np.int64).view(np.float64)[0]
        a[0, 5], a[1, 6], a[:, 7] = np.inf, -np.inf, 5e-324
        ident = {"sum": 0.0, "max": -np.inf, "min": np.inf}[kind]
    elif dtype == torch.int64:
        a = rng.integers(-(2**62), 2**62, (D, L), dtype=np.int64)
        a[:, :8] = 2**63 - 1
        ident = {"sum": 0, "max": -(2**63), "min": 2**63 - 1}[kind]
    else:
        a = rng.integers(0, 64, (D, L)).astype(np.int32)
        ident = {"max": 0, "min": 2**31 - 1}[kind]
    a[D - 1] = ident
    return torch.from_numpy(a).to(dev)


@pytest.mark.cuda
def test_merge_kernel_matches_plain_on_card():
    """H29 against merge_stack_plain, bit for bit, at 2, 4 and 8 shards of
    4096 groups in every lane, and at one shard (a copy)."""
    _need_cards(1)
    from pixie_tpu_torch.ops import merge

    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    lanes = [(torch.int64, "sum"), (torch.float64, "sum"), (torch.int64, "max"),
             (torch.int64, "min"), (torch.int32, "max"), (torch.int32, "min"),
             (torch.float64, "max"), (torch.float64, "min")]
    kernels.reset_launches()
    for D in (2, 4, 8):
        for dtype, kind in lanes:
            stack = _merge_stack(rng, D, 4096, dtype, kind, dev)
            got = merge.merge_stack(stack, kind)
            want = merge.merge_stack_plain(stack, kind)
            assert got.view(torch.uint8).equal(want.view(torch.uint8)), (D, dtype, kind)
    one = _merge_stack(rng, 2, 4096, torch.float64, "sum", dev)[:1]
    assert kernels.merge_states(one, "sum").view(torch.int64).equal(one[0].view(torch.int64))
    assert kernels.LAUNCHES["merge_states"] == 3 * len(lanes) + 1
    with pytest.raises(TypeError):
        kernels.merge_states(torch.zeros((2, 4), dtype=torch.int32, device=dev), "sum")


MESH_QUERY = (  # bench.py config 10's query (tools/microbench_mesh.py)
    "df = px.DataFrame(table='mesh_bench')\n"
    "g = df.groupby('service').agg("
    "n=('lat', px.count), s=('lat', px.sum),"
    " mn=('lat', px.min), mx=('lat', px.max),"
    " u=('service', px.approx_count_distinct),"
    " cm=('status', px.count_min))\n"
    "px.display(g, 'out')\n"
)


@pytest.mark.cuda
@pytest.mark.parametrize("cards,spec", [(2, "d:2"), (4, "hosts:2,d:2")])
def test_mesh_fold_over_cards_equals_logical_shards(cards, spec):
    """Config 10's fold, cold (the stream, a side stream a card) and warm,
    over ``cards`` real cards equals the same geometry over logical shards
    of cuda:0: exact in counts, min/max, HLL and count-min; f64 sums within
    1e-12 * sum |v| of math.fsum. Each card launches its shard's kernels
    and H29 merges on cuda:0."""
    _need_cards(cards)
    from pixie_tpu_torch.distributed import MeshConfig
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.types import DataType, Relation

    rng = np.random.default_rng(21)
    n = 300_000
    data = {"service": np.array([f"svc{i}" for i in rng.integers(0, 64, n)], dtype=object),
            "status": rng.integers(0, 7, n), "lat": rng.standard_normal(n)}
    rel = Relation.of(("service", DataType.STRING), ("status", DataType.INT64),
                      ("lat", DataType.FLOAT64))
    torch.cuda.set_device(0)
    out = {}
    for name, devices in (("cards", [f"cuda:{i}" for i in range(cards)]),
                          ("logical", ["cuda:0"] * cards)):
        ex = DeviceExecutor(block_rows=1 << 14, mesh_config=MeshConfig.parse(spec, cards),
                            devices=devices)
        c = Carnot(device_executor=ex)
        c.table_store.create_table("mesh_bench", rel).write_pydict(
            {k: v.copy() for k, v in data.items()})
        kernels.reset_launches()
        out[name] = [c.execute_query(MESH_QUERY).table("out") for _ in range(2)]
        assert kernels.LAUNCHES["merge_states"] > 0
    want = out["logical"][0]
    for got in out["cards"] + out["logical"][1:]:
        for k in ("service", "n", "mn", "mx", "u", "cm"):
            assert got[k] == want[k], k
        for name, s in zip(got["service"], got["s"]):
            v = data["lat"][data["service"] == name]
            assert abs(s - math.fsum(v)) <= 1e-12 * np.abs(v).sum(), name
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_mesh_lanes_over_cards_equal_logical_shards():
    """The other lanes over 2 real cards against 2 logical shards of cuda:0,
    exactly: a head(n) scan (each card compacts its rows, the root takes the
    prefixes in card order), an INNER join (both sides gathered to cuda:0),
    a join that feeds a group-by (the shards' folds merged by H29) and
    reservoir samples (TREE merges of states copied across cards)."""
    _need_cards(2)
    from pixie_tpu_torch.distributed import MeshConfig
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.types import DataType, Relation
    from pixie_tpu_torch.utils import flags

    rng = np.random.default_rng(23)
    n = 200_000
    svcs = np.array([f"svc-{i}" for i in range(12)], dtype=object)
    fact = {"time_": np.arange(n, dtype=np.int64) * 10, "service": svcs[rng.integers(0, 12, n)],
            "latency": rng.exponential(3e7, n), "bytes": rng.integers(0, 1 << 20, n)}
    owners = {"svc": np.array(list(svcs[:10]) + ["ghost"], dtype=object),
              "owner": np.array([f"team-{i % 3}" for i in range(11)], dtype=object)}
    queries = [
        "df = px.DataFrame(table='fact')\ndf = df[df.bytes >= 900000]\n"
        "df = df[['time_', 'service', 'latency']]\ndf = df.head(5000)\npx.display(df, 'out')\n",
        "f = px.DataFrame(table='fact')\no = px.DataFrame(table='owners')\n"
        "j = f.merge(o, how='inner', left_on=['service'], right_on=['svc'], suffixes=['', '_o'])\n"
        "px.display(j, 'out')\n",
        "f = px.DataFrame(table='fact')\no = px.DataFrame(table='owners')\n"
        "j = o.merge(f, how='inner', left_on=['svc'], right_on=['service'], suffixes=['', '_f'])\n"
        "s = j.groupby(['owner']).agg(n=('latency', px.count), s=('bytes', px.sum),\n"
        "    lo=('latency', px.min), hi=('latency', px.max))\npx.display(s, 'out')\n",
        "df = px.DataFrame(table='fact')\n"
        "s = df.groupby(['service']).agg(r=('latency', px.reservoir_sample),\n"
        "    b=('bytes', px.reservoir_sample), n=('latency', px.count))\npx.display(s, 'out')\n",
    ]
    torch.cuda.set_device(0)
    flags.set("device_join_min_rows", 0)
    try:
        out = {}
        for name, devices in (("cards", ["cuda:0", "cuda:1"]), ("logical", ["cuda:0"] * 2)):
            c = Carnot(device_executor=DeviceExecutor(
                block_rows=1 << 14, mesh_config=MeshConfig.parse("d:2", 2), devices=devices))
            c.table_store.create_table("fact", Relation.of(
                ("time_", DataType.TIME64NS), ("service", DataType.STRING),
                ("latency", DataType.FLOAT64), ("bytes", DataType.INT64))).write_pydict(
                {k: v.copy() for k, v in fact.items()})
            c.table_store.create_table("owners", Relation.of(
                ("svc", DataType.STRING), ("owner", DataType.STRING))).write_pydict(
                {k: v.copy() for k, v in owners.items()})
            kernels.reset_launches()
            out[name] = [c.execute_query(q).table("out") for q in queries for _ in range(2)]
            assert kernels.LAUNCHES["merge_states"] > 0 and kernels.LAUNCHES["scan_compact"] > 0
    finally:
        flags.reset("device_join_min_rows")
    for got, want in zip(out["cards"], out["logical"]):
        assert got == want
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_uncalled_kernels_equal_plain():
    """H30 (count-min query), H31 (hash_columns) and H32 (clz64), the kernels
    of the TPU kernels no path calls, against their plain versions, exactly:
    H30 at config 10's state shape with every depth row holding some
    query's minimum; H31 over -0.0, NaN payloads, +-inf, bool columns, one
    to eight columns and two seeds; H32 over 0, 1, 2^63, 2^64 - 1 and
    every leading-zero count."""
    _need_cards(1)
    dev = torch.device("cuda")
    rng = np.random.default_rng(32)
    kernels.reset_launches()
    G, depth, width = 64, countmin.DEFAULT_DEPTH, countmin.DEFAULT_WIDTH
    state = torch.from_numpy(rng.integers(1000, 2000, (G, depth, width))).to(dev)
    n = 50_000
    gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(-(2**40), 2**40, n)).to(dev)
    cells = countmin._buckets(vals, depth, width)
    for d in range(depth):  # query i's row i % depth holds its minimum
        sel = torch.arange(n, device=dev) % depth == d
        state[gids[sel].long(), d, cells[d][sel].long()] = torch.from_numpy(
            rng.integers(0, 1000, int(sel.sum()))).to(dev)
    got, want = countmin.query(state, gids, vals), countmin.query_plain(state, gids, vals)
    assert torch.equal(got, want)
    per_row = torch.stack([state[gids.long(), d, cells[d].long()] for d in range(depth)])
    assert set(per_row.argmin(0).unique().tolist()) == set(range(depth))
    f = rng.standard_normal(n) * 1e9
    f[:8] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324,
             *np.array([0x7FF8000000000001, -(1 << 51)], dtype=np.int64).view(np.float64)]
    i = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    b = rng.random(n) < 0.5
    cols = {"f": torch.from_numpy(f), "i": torch.from_numpy(i), "b": torch.from_numpy(b)}
    for names in ("f", "b", "ib", "fib", "fbifbifb"):
        for seed in (0, 7):
            host = [cols[c] for c in names]
            got = hashing.hash_columns([t.to(dev) for t in host], seed).cpu()
            assert torch.equal(got, hashing.hash_columns_plain(host, seed)), (names, seed)
    words = torch.from_numpy(np.concatenate([
        i, i >> (np.arange(n) % 64), np.array([0, 1, -(2**63), -1], dtype=np.int64)]))
    got = hashing.clz64(words.to(dev)).cpu()
    assert torch.equal(got, hashing.clz64_plain(words))
    assert got[-4:].tolist() == [64, 63, 0, 0] and set(got.tolist()) == set(range(65))
    assert kernels.LAUNCHES["countmin_query"] == 1
    assert kernels.LAUNCHES["hash_columns"] == 10 and kernels.LAUNCHES["clz64"] == 1
    with pytest.raises(ValueError):
        kernels.hash_columns([cols["i"].to(dev)] * 9, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cards,spec", [(2, "hosts:2,d:1"), (4, "hosts:2,d:2")])
def test_partitioned_join_and_resume_over_cards(cards, spec):
    """The partitioned join (each host's shards concatenated onto its first
    card) and a stream fold resumed from its window checkpoint after a host
    loss, over ``cards`` real cards, equal the same geometry over logical
    shards of cuda:0: the join rows exactly, in order; the fold's outputs
    exactly but the f64 sums (within 1e-12 * sum |v| of math.fsum), and the
    same resume."""
    _need_cards(cards)
    from pixie_tpu_torch.distributed import MeshConfig
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.types import DataType, Relation
    from pixie_tpu_torch.utils import faults, flags

    rng = np.random.default_rng(33)
    n = 200_000
    svcs = np.array([f"svc-{i}" for i in range(12)], dtype=object)
    fact = {"time_": np.arange(n, dtype=np.int64) * 10, "service": svcs[rng.integers(0, 12, n)],
            "latency": rng.exponential(3e7, n)}
    owners = {"svc": np.array(list(svcs[:10]) + ["ghost"], dtype=object),
              "owner": np.array([f"team-{i % 3}" for i in range(11)], dtype=object)}
    mb = {"service": np.array([f"svc{i}" for i in rng.integers(0, 64, n)], dtype=object),
          "status": rng.integers(0, 7, n), "lat": rng.standard_normal(n)}
    joins = [
        "f = px.DataFrame(table='fact')\no = px.DataFrame(table='owners')\n"
        f"j = f.merge(o, how='{how}', left_on=['service'], right_on=['svc'], "
        "suffixes=['', '_o'])\npx.display(j, 'out')\n"
        for how in ("inner", "outer")
    ]
    torch.cuda.set_device(0)
    flags.set("device_join_min_rows", 0)
    flags.set("streaming_window_rows", n // 8)
    out = {}
    try:
        for name, devices in (("cards", [f"cuda:{i}" for i in range(cards)]),
                              ("logical", ["cuda:0"] * cards)):
            ex = DeviceExecutor(block_rows=1 << 14, mesh_config=MeshConfig.parse(spec, cards),
                                devices=devices)
            c = Carnot(device_executor=ex)
            c.table_store.create_table("fact", Relation.of(
                ("time_", DataType.TIME64NS), ("service", DataType.STRING),
                ("latency", DataType.FLOAT64))).write_pydict({k: v.copy() for k, v in fact.items()})
            c.table_store.create_table("owners", Relation.of(
                ("svc", DataType.STRING), ("owner", DataType.STRING))).write_pydict(
                {k: v.copy() for k, v in owners.items()})
            c.table_store.create_table("mesh_bench", Relation.of(
                ("service", DataType.STRING), ("status", DataType.INT64),
                ("lat", DataType.FLOAT64))).write_pydict({k: v.copy() for k, v in mb.items()})
            segment.reduce_lanes(reset=True)
            rows = [c.execute_query(q).table("out") for q in joins for _ in range(2)]
            assert segment.reduce_lanes(reset=True) == {"join_partitioned": 4}
            faults.arm("mesh.host_loss", count=1, after=4)
            try:
                fold = c.execute_query(MESH_QUERY).table("out")
            finally:
                faults.reset()
            assert ex.last_resume_stats == {"resumed_from_window": 4, "refolded_windows": 4,
                                            "total_windows": 8}
            out[name] = (rows, fold)
    finally:
        flags.reset("device_join_min_rows")
        flags.reset("streaming_window_rows")
    assert out["cards"][0] == out["logical"][0]
    got, want = out["cards"][1], out["logical"][1]
    for k in ("service", "n", "mn", "mx", "u", "cm"):
        assert got[k] == want[k], k
    for name, s in zip(got["service"], got["s"]):
        v = mb["lat"][mb["service"] == name]
        assert abs(s - math.fsum(v)) <= 1e-12 * np.abs(v).sum(), name
    assert torch.cuda.current_device() == 0
