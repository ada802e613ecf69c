"""Bit-exactness of pixie_tpu_torch.ops.hashing (plain versions of the hash
kernel's __device__ functions) against pixie_tpu.ops.hashing's u32 path on
the CPU, over edge values: 0, -1, int64 min/max, negatives, +-0.0, NaN
payloads, +-inf, subnormals, and narrow int and bool columns. Every hash is
held exactly equal, bit for bit (Fault-2, ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.ops import hashing as ref
from pixie_tpu_torch.ops import hashing

# Two intra-op threads: the CPU tests share the host with the reference's
# timing-sensitive tests under several workers.
torch.set_num_threads(2)

I64 = np.iinfo(np.int64)


def _ints(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(I64.min, I64.max, 20_000, dtype=np.int64)
    x[:12] = [0, -1, 1, I64.min, I64.max, I64.min + 1, I64.max - 1,
              1 << 32, (1 << 32) - 1, -(1 << 32), 1024, 65534]
    return x


def _floats(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1e9, 20_000)
    nan_payload = np.array([0x7FF8000000000001, 0xFFF8000000000000 - (1 << 64)],
                           dtype=np.int64).view(np.float64)
    x[:10] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, -5e-324,
              np.finfo(np.float64).max, *nan_payload]
    return x


def _float32() -> np.ndarray:
    with np.errstate(over="ignore"):  # float64 max -> inf
        return _floats(3).astype(np.float32)


def _columns():
    ints = _ints(1)
    return {
        "int64": ints,
        "float64": _floats(2),
        "float32": _float32(),
        "int32": ints.astype(np.int32),
        "uint16": (ints & 0xFFFF).astype(np.uint16),
        "uint8": (ints & 0xFF).astype(np.uint8),
        "bool": ints % 3 == 0,
    }


@pytest.mark.parametrize("kind", list(_columns()))
@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF])
def test_hash32_and_pair_bit_exact(kind, seed):
    x = _columns()[kind]
    want = np.asarray(ref.hash32(jnp.asarray(x), seed)).astype(np.int64)
    got = hashing.hash32(torch.from_numpy(x), seed).numpy()
    np.testing.assert_array_equal(got, want)
    wa, wb = ref.hash32_pair(jnp.asarray(x), seed)
    ga, gb = hashing.hash32_pair(torch.from_numpy(x), seed)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa).astype(np.int64))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb).astype(np.int64))


@pytest.mark.parametrize("kind", ["int64", "float64", "int32", "bool"])
def test_u32_words_bit_exact(kind):
    x = _columns()[kind]
    wlo, whi = ref.u32_words(jnp.asarray(x))
    glo, ghi = hashing.u32_words(torch.from_numpy(x))
    np.testing.assert_array_equal(glo.numpy(), np.asarray(wlo).astype(np.int64))
    np.testing.assert_array_equal(ghi.numpy(), np.asarray(whi).astype(np.int64))


def test_float_words_keep_signed_zero_and_nan_payloads():
    """-0.0 and +0.0, and two NaNs with different payloads, hash apart, as
    the reference's bitcast does."""
    x = torch.tensor(_floats(4)[[0, 1, 8, 9]])
    h = hashing.hash32(x)
    assert h[0] != h[1] and h[2] != h[3]


def test_mix32_and_clz32_bit_exact():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 1 << 32, 50_000, dtype=np.uint64).astype(np.uint32)
    u[:6] = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    for seed in (0, 1, 0x85EBCA77):
        np.testing.assert_array_equal(
            hashing.mix32(torch.from_numpy(u.astype(np.int64)), seed).numpy(),
            np.asarray(ref.mix32(jnp.asarray(u), seed)).astype(np.int64),
        )
    # every bit length, and random values
    powers = np.array([0] + [1 << k for k in range(32)], dtype=np.uint64).astype(np.uint32)
    for v in (u, powers, powers - 1):
        np.testing.assert_array_equal(
            hashing.clz32(torch.from_numpy(v.astype(np.int64))).numpy(),
            np.asarray(ref.clz32(jnp.asarray(v))),
        )


# -- the 64-bit path (K9's splitmix64, hash64, combine, hash_columns, clz64) ----
SEEDS64 = [0, 1, 7, 0x9E3779B9, (1 << 40) + 3]


def _u64_view(a) -> np.ndarray:
    return np.array(a).view(np.int64)


@pytest.mark.parametrize("kind", list(_columns()))
@pytest.mark.parametrize("seed", SEEDS64)
def test_hash64_bit_exact(kind, seed):
    """Every column kind, NaN payloads, +-0, INT64_MIN and narrow ints
    (sign-extended, as ``astype(uint64)``), bit for bit."""
    x = _columns()[kind]
    want = _u64_view(ref.hash64(jnp.asarray(x), seed))
    got = hashing.hash64(torch.from_numpy(x), seed).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash64_float_words_keep_signed_zero_and_nan_payloads():
    x = torch.tensor(_floats(4)[[0, 1, 8, 9]])
    h = hashing.hash64(x)
    assert h[0] != h[1] and h[2] != h[3]


def test_splitmix64_and_combine_bit_exact():
    x = _ints(5)
    y = _ints(6)
    np.testing.assert_array_equal(
        hashing.splitmix64(torch.from_numpy(x)).numpy(),
        _u64_view(ref.splitmix64(jnp.asarray(x.view(np.uint64)))),
    )
    hx, hy = ref.hash64(jnp.asarray(x)), ref.hash64(jnp.asarray(y))
    np.testing.assert_array_equal(
        hashing.combine(torch.from_numpy(_u64_view(hx)), torch.from_numpy(_u64_view(hy))).numpy(),
        _u64_view(ref.combine(hx, hy)),
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_hash_columns_bit_exact(seed):
    """No caller in either package: the plain version against the
    reference's."""
    cols = [_ints(7), _floats(8), _ints(9).astype(np.int32)]
    want = _u64_view(ref.hash_columns([jnp.asarray(c) for c in cols], seed))
    got = hashing.hash_columns([torch.from_numpy(c) for c in cols], seed).numpy()
    np.testing.assert_array_equal(got, want)


def _edge_bools(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = rng.random(20_000) < 0.5
    b[:2] = [False, True]
    return b


@pytest.mark.parametrize("cols", [
    ["f64"], ["bool"], ["f64", "bool"], ["bool", "i64", "f32"],
    ["i64", "f64", "bool", "i32", "f32", "i64", "f64", "bool"],
])
@pytest.mark.parametrize("seed", [0, 5])
def test_hash_columns_edge_words_bit_exact(cols, seed):
    """H31's plain version against the reference on the edge words: -0.0
    and +0.0 and NaN payloads (f64 bit-cast, f32 widened first), bool
    columns as 0/1, INT64_MIN/MAX, one column and eight."""
    make = {
        "i64": lambda i: _ints(20 + i), "f64": lambda i: _floats(30 + i),
        "bool": lambda i: _edge_bools(40 + i), "i32": lambda i: _ints(50 + i).astype(np.int32),
        "f32": lambda i: _floats(60 + i).astype(np.float32),
    }
    with np.errstate(over="ignore"):  # f64 max narrows to f32 inf
        arrs = [make[k](i) for i, k in enumerate(cols)]
    want = _u64_view(ref.hash_columns([jnp.asarray(a) for a in arrs], seed))
    got = hashing.hash_columns([torch.from_numpy(a) for a in arrs], seed).numpy()
    np.testing.assert_array_equal(got, want)


def test_clz64_edge_words():
    words = np.array([0, 1, 1 << 63, (1 << 63) - 1, (1 << 64) - 1, 1 << 62, 2, 3],
                     dtype=np.uint64)
    want = np.asarray(ref.clz64(jnp.asarray(words)))
    got = hashing.clz64(torch.from_numpy(words.view(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [64, 63, 0, 1, 0, 1, 62, 62]


def test_clz64_bit_exact():
    """No caller in either package: every leading-zero count 0..64."""
    x = _ints(10).view(np.uint64)
    shifts = np.arange(len(x), dtype=np.uint64) % np.uint64(64)
    words = np.concatenate([x, x >> shifts, np.array([0, 1, 1 << 63], np.uint64)])
    want = np.asarray(ref.clz64(jnp.asarray(words)))
    got = hashing.clz64(torch.from_numpy(words.view(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == set(range(65))
