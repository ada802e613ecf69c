"""The predicate-batched fold's slot-batched segment sums (K16's H23) over
rows as the fold stages them, against the reference's vmapped sum-family
updates (pixie_tpu/parallel/pipeline.py:5597-5600: ``seg_sum`` and
``seg_count`` of pixie_tpu/ops/segment.py under every slot's mask) on both
of its segment lanes, on the CPU (the port's plain version of H23).

Rows: integer rows as staged (uint8, uint16 and int32 narrowed with their
offsets, int64, bool) and f64 rows (f64, a narrowed int32 and a bool row
summed as f64). Held: the integer sums (mod 2^64) and every slot's
presence exactly; the f64 sums within 1e-12 * sum |v| of their cell's exact
sum (math.fsum), and of the reference's within that plus the reference
lane's own bound (its matmul lane adds f32 parts in chunks of _F64_CHUNK
rows: _F64_CHUNK * 2^-24 * sum |v|).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.ops import segment as ref_segment
from pixie_tpu_torch.ops import batched, segment

torch.set_num_threads(2)

N, S, B = 4000, 16, 7


@pytest.fixture(params=["matmul", "scatter"])
def ref_lane(request):
    ref_segment.set_strategy(request.param)
    yield request.param
    ref_segment.set_strategy(None)


def _staged(seed: int):
    """(integer rows as staged, their int64 values; f64 rows as staged, their
    f64 values; gids; bits)."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, N).astype(np.uint8)
    u16 = rng.integers(0, 65536, N).astype(np.uint16)
    i32 = rng.integers(-(2**31), 2**31, N).astype(np.int32)
    i64 = rng.integers(-(2**62), 2**62, N)
    flag = rng.random(N) < 0.3
    f64 = rng.exponential(3e7, N)
    f64[:4] = [0.0, -0.0, 1e-300, -2.5e8]
    offs = (200, -(2**40), 2**62)
    irows = [segment.Narrow(torch.from_numpy(u8), offs[0]),
             segment.Narrow(torch.from_numpy(u16), offs[1]),
             segment.Narrow(torch.from_numpy(i32), offs[2]),
             torch.from_numpy(i64), torch.from_numpy(flag)]
    ivals = [u8.astype(np.int64) + offs[0], u16.astype(np.int64) + offs[1],
             i32.astype(np.int64) + offs[2], i64, flag.astype(np.int64)]
    frows = [torch.from_numpy(f64), segment.Narrow(torch.from_numpy(i32), 1000),
             torch.from_numpy(flag)]
    fvals = [f64, (i32.astype(np.int64) + 1000).astype(np.float64), flag.astype(np.float64)]
    gids = rng.integers(-2, S + 2, N).astype(np.int32)
    bits = rng.integers(0, 1 << B, N).astype(np.int32)
    return irows, ivals, frows, fvals, gids, bits


def _ref_vmapped(ivals, fvals, gids, bits):
    """The reference's sum-family updates vmapped over the slots' masks."""
    masks = jnp.asarray((bits[None, :] >> np.arange(B)[:, None]) & 1).astype(bool)
    g = jnp.asarray(gids)
    ints = jax.vmap(lambda m: jnp.stack(
        [ref_segment.seg_sum(jnp.asarray(v), g, S, mask=m) for v in ivals]
        + [ref_segment.seg_count(g, S, mask=m)]))(masks)
    flts = jax.vmap(lambda m: jnp.stack(
        [ref_segment.seg_sum(jnp.asarray(v), g, S, mask=m) for v in fvals]))(masks)
    return np.asarray(ints), np.asarray(flts)


@pytest.mark.parametrize("seed", [0, 1])
def test_staged_rows_match_reference_vmapped_update(ref_lane, seed):
    irows, ivals, frows, fvals, gids, bits = _staged(seed)
    got_i, got_f = batched.batched_segment_sums(irows, frows, torch.from_numpy(gids),
                                                torch.from_numpy(bits), B, S)
    want_i, want_f = _ref_vmapped(ivals, fvals, gids, bits)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    lane = ref_segment._F64_CHUNK * 2.0**-24 if ref_lane == "matmul" else 0.0
    ok = (gids >= 0) & (gids < S)
    for s in range(B):
        for f, v in enumerate(fvals):
            for g in range(S):
                sel = ok & (gids == g) & (((bits >> s) & 1) == 1)
                exact, scale = math.fsum(v[sel]), math.fsum(np.abs(v[sel]))
                assert abs(got_f[s, f, g].item() - exact) <= 1e-12 * scale
                assert abs(got_f[s, f, g].item() - want_f[s, f, g]) <= (2e-12 + lane) * scale


def test_staged_rows_equal_their_widened_stack():
    """The plain version widens a staged row to the value H23 reads: the
    same sums as the rows widened beforehand and stacked, bit for bit."""
    irows, ivals, frows, fvals, gids, bits = _staged(2)
    g, b = torch.from_numpy(gids), torch.from_numpy(bits)
    got_i, got_f = batched.batched_segment_sums(irows, frows, g, b, B, S)
    want_i, want_f = batched.batched_segment_sums(
        torch.from_numpy(np.stack(ivals)), torch.from_numpy(np.stack(fvals)), g, b, B, S)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_f.view(torch.int64), want_f.view(torch.int64))
