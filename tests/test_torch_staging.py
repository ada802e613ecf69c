"""Parity of pixie_tpu_torch.parallel.staging with pixie_tpu.parallel.staging:
block geometry, frame-of-reference narrowing, and the staged blocks, mask
and offsets on a one-device reference mesh (default flags, so the reference
stages through its codec, which decodes bit-identically). All exact."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pixie_tpu.parallel import staging as ref_staging
from pixie_tpu_torch.parallel import staging

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)


@pytest.mark.parametrize("num_rows", [0, 1, 255, 1000, 1 << 14, 70_001, 200_000])
@pytest.mark.parametrize("block_rows", [1 << 12, 1 << 14, 1 << 17])
def test_block_geometry(num_rows, block_rows):
    assert staging.block_geometry(num_rows, 1, block_rows) == (
        ref_staging.block_geometry(num_rows, 1, block_rows)
    )


@pytest.mark.parametrize(
    "arr",
    [
        np.array([200, 301, 404, 500] * 10, np.int64),  # uint16
        np.arange(5, 200, dtype=np.int64),  # uint8
        np.array([-(2**40), 2**20], np.int64),  # too wide for int32
        np.array([-(2**30), 2**30], np.int64),  # int32
        np.arange(16, dtype=np.int32),  # dictionary codes
        np.linspace(0, 1, 7),  # floats stay as they are
        np.empty(0, np.int64),
    ],
)
def test_narrow_int(arr):
    got, off = staging._narrow_int(arr)
    want, want_off = ref_staging._narrow_int(arr)
    assert off == want_off
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_staged_blocks_mask_and_offsets():
    rng = np.random.default_rng(0)
    n = 70_001
    cols = {
        "service": rng.integers(0, 16, n).astype(np.int32),
        "resp_status": rng.choice(np.array([200, 301, 404, 500]), n),
        "latency": rng.exponential(3e7, n),
        "big": rng.integers(-(2**62), 2**62, n),
    }
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    ref = ref_staging.stage_columns(
        mesh, dict(cols), n, block_rows=1 << 14, f32_cols={"latency"}
    )
    got = staging.stage_columns(
        dict(cols), n, "cpu", block_rows=1 << 14, f32_cols={"latency"}
    )
    assert sorted(got.blocks) == sorted(ref.blocks)
    for name, blk in ref.blocks.items():
        want = np.asarray(blk)
        have = got.blocks[name].numpy()
        assert have.shape == want.shape
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert got.narrow_offsets == ref.narrow_offsets
    assert got.block_rows == ref.block_rows
    assert got.num_blocks == np.asarray(ref.mask).shape[1]
    # Widening on the device restores the values exactly (uint16 -> int64).
    rs = got.blocks["resp_status"].to(torch.int64) + got.narrow_offsets["resp_status"]
    np.testing.assert_array_equal(rs.reshape(-1)[:n].numpy(), cols["resp_status"])


@pytest.mark.parametrize("num_groups", [1, 16, 256, 257, 4096, 65536, 65537])
def test_narrow_gids(num_groups):
    gids = np.random.default_rng(num_groups).integers(0, num_groups, 5_000).astype(np.int32)
    got = staging._narrow_gids(gids, num_groups)
    want = ref_staging._narrow_gids(gids, num_groups)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_host_gids_stage_as_a_lane():
    """Host-densified gids ship narrowed (uint16 at 4096 groups), padded like
    every column, and widen back to the gids."""
    n = 70_001
    gids = np.random.default_rng(1).integers(0, 4096, n).astype(np.int32)
    staged = staging.stage_columns(
        {"x": np.arange(n, dtype=np.int64)}, n, "cpu", block_rows=1 << 14,
        gids=gids, num_groups=4096,
    )
    assert staged.gids.dtype == torch.uint16
    assert staged.gids.shape == staged.mask.shape
    flat = staged.gids.reshape(-1).to(torch.int32).numpy()
    np.testing.assert_array_equal(flat[:n], gids)
    assert not flat[n:].any()
