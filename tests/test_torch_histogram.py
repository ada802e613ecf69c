"""Parity of pixie_tpu_torch.ops.histogram (plain versions of kernels H3/H4)
with the reference pixie_tpu.ops.histogram on the CPU.

- The Fault-1 contract (PERF.md): f32 ``log`` differs between XLA and
  PyTorch by an ulp now and then, so a bin may differ from the reference's,
  by exactly one, and only for a value whose f64 bin coordinate
  x = log(v / min) / log(gamma) lies within 2.5e-4 of an integer (a bin
  edge). Over 1M exponential(3e7) values at most 1e-3 of the rows may differ.
- Given identical bins, ``update`` counts are exactly equal (under both
  reference strategies).
- ``quantile_values`` of one state, carried across with interop, agree
  within a relative 1e-12; so does the plain version at H4's edge states
  (``ops/quantile_edges.py``: empty, bin 0, one bin, counts near 2^40,
  widths other than 1024, 40 qs).
- H4's midpoint table is the plain version's value of each bin bit for bit,
  and a model of H4's warp search (lanes of 32 bins, chunks of 1024, a
  lower bound over the running maximum of the cumulative counts) returns
  the plain version's bits, also where counts are negative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.ops import histogram as ref_hist
from pixie_tpu.ops import segment as ref_segment
from pixie_tpu.udf.builtins.sketch_ops import QUANTILE_QS
from pixie_tpu.udf.registry import default_registry as ref_registry
from pixie_tpu_torch import interop
from pixie_tpu_torch.ops import histogram, kernels
from pixie_tpu_torch.ops.quantile_edges import HIST_NBINS, QS, QS_WIDE, hist_edge_state
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.builtins.sketch_ops import QUANTILE_QS as PORT_QS
from pixie_tpu_torch.udf.registry import default_registry

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

EDGE = 2.5e-4


def _coord(v: np.ndarray) -> np.ndarray:
    spec = ref_hist.DEFAULT_SPEC
    return np.log(np.maximum(v, spec.min_value) / spec.min_value) / np.log(spec.gamma)


def _near_edge(v: np.ndarray) -> np.ndarray:
    x = _coord(v)
    return np.abs(x - np.round(x)) <= EDGE


def test_bin_index_fault1_contract():
    v = np.random.default_rng(0).exponential(3e7, 1 << 20)
    want = np.asarray(ref_hist.bin_index(jnp.asarray(v))).astype(np.int64)
    got = histogram.bin_index(torch.from_numpy(v)).numpy().astype(np.int64)
    diff = got != want
    assert np.all(np.abs(got - want) <= 1)
    assert np.all(_near_edge(v[diff]))
    assert diff.sum() <= 1e-3 * v.size


def test_bin_index_edges_and_clip():
    spec = histogram.DEFAULT_SPEC
    v = np.array(
        [0.0, -5.0, 0.5, 1.0, 1.0000001, 2.0, 1e6, 1e12, 1e13, np.inf,
         -np.inf, np.nan, 1e-45]
    )
    want = np.asarray(ref_hist.bin_index(jnp.asarray(v)))
    got = histogram.bin_index(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[8] == spec.nbins - 1


@pytest.mark.parametrize("strategy", ["matmul", "scatter"])
def test_update_counts_exact(strategy):
    rng = np.random.default_rng(1)
    n, S = 50_000, 16
    v = rng.exponential(3e7, n)
    v = v[~_near_edge(v)]  # identical bins by the contract above
    n = v.size
    gids = rng.integers(0, S, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    ref_segment.set_strategy(strategy)
    try:
        want = np.asarray(
            ref_hist.update(
                ref_hist.init(S), jnp.asarray(gids), jnp.asarray(v), jnp.asarray(mask)
            )
        )
    finally:
        ref_segment.set_strategy(None)
    got = histogram.update(
        histogram.init(S, "cpu"),
        torch.from_numpy(gids),
        torch.from_numpy(v),
        torch.from_numpy(mask),
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantile_values_on_carried_state():
    rng = np.random.default_rng(2)
    S = 12
    state = rng.integers(0, 1000, (S, 1024)).astype(np.int64)
    state[3] = 0  # empty group -> 0
    state[4] = 0
    state[4, 0] = 7  # everything in bin 0 -> min
    state[5, :500] = 0  # sparse low tail
    ref_uda = ref_registry().lookup_uda("quantiles", [DataType.FLOAT64])
    uda = default_registry().lookup_uda("quantiles", [DataType.FLOAT64])
    want = np.asarray(ref_uda.device_finalize(jnp.asarray(state)))
    carried = interop.state_from_numpy(uda, state)
    got = uda.device_finalize(carried).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert list(uda.format_output(got)) == list(ref_uda.format_output(want))
    assert PORT_QS == QUANTILE_QS


# H3's lanes (ops/kernels h3_lane): the whole [S, nbins] partial of u16
# counts (two a word, rounded up to 16 bytes) in each CTA of a cluster
# while it fits the opt-in shared memory, global atomics beyond; at the
# boundary, for the H100's 227 KB and two smaller limits.
@pytest.mark.parametrize("optin", [232448, 101376, 49152])
@pytest.mark.parametrize("nbins", [1024, 100])
def test_h3_lane_boundaries(optin, nbins):
    whole = lambda S: -(-S * nbins // 8) * 16  # noqa: E731
    last_cluster = max(S for S in range(1, 20000) if whole(S) <= optin)
    assert kernels.h3_lane(1, nbins, optin) == ("cluster", 8)
    assert kernels.h3_lane(last_cluster, nbins, optin) == ("cluster", 8)
    assert kernels.h3_lane(last_cluster + 1, nbins, optin) == ("global", 0)
    if (optin, nbins) == (232448, 1024):  # the main paths' S = 16, then 64 and 600
        assert last_cluster == 113
        assert [kernels.h3_lane(S, nbins, optin)[0] for S in (16, 64, 600)] == [
            "cluster", "cluster", "global"]
    with pytest.raises(ValueError):
        kernels.h3_lane(0, nbins, optin)


def _off_edge_values(rng, n: int) -> np.ndarray:
    """n exponential(3e7) values, none within the Fault-1 distance of a
    bin edge (redrawn until so), a few at and below min and past max."""
    v = rng.exponential(3e7, n)
    v[:5] = [0.0, -3.0, 0.5, 2e12, 5e13]
    bad = _near_edge(v)
    while bad.any():
        v[bad] = rng.exponential(3e7, int(bad.sum()))
        bad = _near_edge(v)
    return v


# The plain version of H3 against the reference's update under both of
# its lanes, at each of H3's lanes' S: 2^16 + 3 rows, gids out of range,
# with and without a mask; counts exactly equal (no row lies near a bin
# edge).
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("S", [16, 64, 600])
@pytest.mark.parametrize("strategy", ["matmul", "scatter"])
def test_update_plain_matches_reference_at_h3_lanes(strategy, S, masked):
    rng = np.random.default_rng([S, masked])
    n = (1 << 16) + 3
    v = _off_edge_values(rng, n)
    gids = rng.integers(-2, S + 2, n).astype(np.int32)
    mask = rng.random(n) < 0.8 if masked else None
    ref_segment.set_strategy(strategy)
    try:
        want = np.asarray(ref_hist.update(
            ref_hist.init(S), jnp.asarray(gids), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask)))
    finally:
        ref_segment.set_strategy(None)
    got = histogram.update_plain(
        histogram.init(S, "cpu"), torch.from_numpy(gids), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    ok = (gids >= 0) & (gids < S) & (True if mask is None else mask)
    assert got.sum() == ok.sum()


@pytest.mark.parametrize("qs", [QS, QS_WIDE], ids=["qs7", "qs40"])
@pytest.mark.parametrize("nbins", HIST_NBINS)
def test_quantile_values_plain_edges_match_reference(nbins, qs):
    """The plain version of H4 against the reference's quantile_values at
    the edge states, within a relative 1e-12."""
    state = hist_edge_state(nbins, 12, seed=nbins)
    ref_spec = ref_hist.LogHistogramSpec(nbins=nbins)
    spec = histogram.LogHistogramSpec(nbins=nbins)
    want = np.asarray(ref_hist.quantile_values(jnp.asarray(state), qs, ref_spec))
    got = histogram.quantile_values_plain(torch.from_numpy(state), qs, spec).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert not got[0].any() and np.all(got[1] == spec.min_value)


@pytest.mark.parametrize("nbins", [1024, 100])
def test_midpoint_table_is_plain_bin_by_bin(nbins):
    """Group b holds one count in bin b, so every q lands on bin b: the
    plain version's value there equals the table's entry bit for bit; the
    table is built once per (spec, device)."""
    spec = histogram.LogHistogramSpec(nbins=nbins)
    state = torch.diag(torch.ones(nbins, dtype=torch.int64))
    plain = histogram.quantile_values_plain(state, (0.5,), spec)[:, 0]
    table = histogram.midpoint_table(spec, "cpu")
    assert table.dtype == torch.float64 and table.shape == (nbins,)
    assert torch.equal(plain.view(torch.int64), table.view(torch.int64))
    assert histogram.midpoint_table(spec, torch.device("cpu")) is table


def _h4_model(state: np.ndarray, qs, table: np.ndarray) -> np.ndarray:
    """H4 as its warp computes it: chunks of 1024 bins, 32 lanes of 32
    consecutive bins, the int64 cumulative counts converted to f64 once and
    their running maximum taken (the keys, carried across chunks); per q a
    target max(q * total, 1e-9), a five-step lower bound over the lanes'
    last keys, then the count of that lane's keys below the target; bin 0
    when no key reaches; the value from the table, 0 for an empty group."""
    S, nbins = state.shape
    nch = -(-nbins // 1024)
    out = np.zeros((S, len(qs)))
    for g in range(S):
        b = np.zeros(nch * 1024, np.int64)
        b[:nbins] = state[g]
        total = int(b.sum())
        keys = np.maximum.accumulate(np.cumsum(b).astype(np.float64)).reshape(nch, 32, 32)
        for j, q in enumerate(qs):
            target = max(q * float(total), 1e-9)
            bin_ = 0
            for c in range(nch):
                if keys[c, 31, 31] < target:
                    continue
                pos = 0
                for d in (16, 8, 4, 2, 1):
                    pos += d if keys[c, pos + d - 1, 31] < target else 0
                bin_ = c * 1024 + pos * 32 + int((keys[c, pos] < target).sum())
                break
            out[g, j] = table[bin_] if total > 0 else 0.0
    return out


@pytest.mark.parametrize("nbins", HIST_NBINS)
def test_h4_model_matches_plain(nbins):
    """The model of H4's search returns the plain version's bits at the
    edge states and at a state with negative counts (the running maximum
    keeps the first reaching bin), for 7 qs and 40."""
    spec = histogram.LogHistogramSpec(nbins=nbins)
    state = hist_edge_state(nbins, 12, seed=nbins + 1)
    rng = np.random.default_rng(nbins)
    state[-1] = rng.integers(-1000, 1000, nbins)
    state[-1, nbins // 2] = 50_000
    table = histogram.midpoint_table(spec, "cpu").numpy()
    for qs in (QS, QS_WIDE):
        want = histogram.quantile_values_plain(torch.from_numpy(state), qs, spec).numpy()
        got = _h4_model(state, qs, table)
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
