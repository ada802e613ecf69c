"""32-bit hash functions of the sketches (HyperLogLog registers, count-min
buckets), bit for bit those of pixie_tpu/ops/hashing.py's u32 path.

PyTorch has no uint32 arithmetic, so the plain versions hold every u32 value
in an int64 tensor in [0, 2^32) and mask with ``& 0xFFFFFFFF`` after each
multiply, add and left shift: int64 products wrap mod 2^64, so their low 32
bits are exact. A column reaches the hash as its 64-bit word (``words64``):
an int64 as it is, a float bit-cast from float64 (so +-0.0 and NaN payloads
stay distinct, as in the reference), a narrower int cast to u32.

On a CUDA tensor ``hash32`` and ``hash32_pair`` launch the hash kernel of
``ops/kernels`` (the same ``__device__`` functions H5 and the count-min path
use); on a CPU tensor the plain versions below run.

The 64-bit path (splitmix64, hash64, combine, hash_columns, clz64) holds
each u64 in an int64 tensor: products and sums wrap mod 2^64 as the u32
path relies on (Fault-2), a logical right shift is ``(x >> s) & (2^(64-s) -
1)``. Its ``__device__`` versions are ``kernels/hash64.cuh``, which H25
(the reservoir's priorities) and H31 inline. On a CUDA tensor
``hash_columns`` launches H31 and ``clz64`` H32; neither has a caller in
either package yet.
"""

from __future__ import annotations

import torch

from pixie_tpu_torch.ops import kernels

M32 = 0xFFFFFFFF


def words64(x: torch.Tensor) -> torch.Tensor:
    """int64 [n]: the 64-bit word each value hashes as — (hi << 32) | lo of
    the reference's ``u32_words``."""
    if x.is_floating_point():
        return x.to(torch.float64).view(torch.int64)
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & M32  # astype(uint32): wraps negatives


def u32_words(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) u32 words of any column, as int64 in [0, 2^32)."""
    w = words64(x)
    return w & M32, (w >> 32) & M32


def mix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3 fmix32 on u32 values held in int64."""
    x = x ^ (seed & M32)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def hash32_plain(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Plain version of the hash kernel's hash32, on any device."""
    lo, hi = u32_words(x)
    return mix32(lo ^ mix32(hi, 0x9E3779B9 ^ seed), 0x85EBCA77 ^ seed)


def hash32_pair_plain(x: torch.Tensor, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the hash kernel's hash32_pair, on any device."""
    lo, hi = u32_words(x)
    a = mix32(lo ^ mix32(hi, 0x9E3779B9 ^ seed), 0x85EBCA77 ^ seed)
    b = mix32(hi ^ mix32(lo, 0xC2B2AE35 ^ seed), 0x27D4EB2F ^ seed)
    return a, b


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """u32 hash of each value, as int64 in [0, 2^32)."""
    if x.is_cuda:
        w = words64(x).contiguous()
        return kernels.hash32(w, seed, pair=False)[0].to(torch.int64) & M32
    return hash32_plain(x, seed)


def hash32_pair(x: torch.Tensor, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent u32 hashes (the Kirsch-Mitzenmacher base pair), as
    int64 in [0, 2^32)."""
    if x.is_cuda:
        h = kernels.hash32(words64(x).contiguous(), seed, pair=True).to(torch.int64) & M32
        return h[0], h[1]
    return hash32_pair_plain(x, seed)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """int32 count of leading zeros of u32 values held in int64 (32 for 0),
    by a binary search over the top bits."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_clear = (x >> (32 - s)) == 0
        n = n + torch.where(top_clear, s, 0)
        x = torch.where(top_clear, (x << s) & M32, x)
    return (n + (x == 0).to(n.dtype)).to(torch.int32)


# -- 64-bit path ---------------------------------------------------------------
M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """The int64 that holds the u64 constant ``c``."""
    c &= M64
    return c - (1 << 64) if c >> 63 else c


GOLDEN64 = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def srl64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 values held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer on u64 values held in int64."""
    z = x.to(torch.int64) + GOLDEN64
    z = (z ^ srl64(z, 30)) * _MIX1
    z = (z ^ srl64(z, 27)) * _MIX2
    return z ^ srl64(z, 31)


def words_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 [n]: the u64 each value hashes as in the reference's ``hash64``:
    a float bit-cast from float64 (so +0.0 and -0.0 hash apart), a bool as
    0/1, an int sign-extended (``astype(uint64)``)."""
    if x.is_floating_point():
        return x.to(torch.float64).view(torch.int64)
    return x.to(torch.int64)


def hash64(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """u64 hash of each value (held in int64); plain on any device."""
    return splitmix64(words_u64(x) ^ _i64(seed * 0x9E3779B97F4A7C15))


def combine(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Order-dependent (boost-style) combine of two u64 hashes."""
    return splitmix64(h1 ^ (h2 + GOLDEN64 + (h1 << 6) + srl64(h1, 2)))


def hash_columns(cols: list, seed: int = 0) -> torch.Tensor:
    """Row-wise u64 hash of a multi-column key (no caller in either
    package): one H31 launch on CUDA, each column as the word ``hash64``
    reads (a float as float64 bits, a bool as 0/1, an int sign-extended)."""
    if cols[0].is_cuda:
        words = [c if c.dtype in (torch.bool, torch.float64) else
                 c.to(torch.float64) if c.is_floating_point() else c.to(torch.int64)
                 for c in cols]
        return kernels.hash_columns([w.contiguous() for w in words], seed)
    return hash_columns_plain(cols, seed)


def hash_columns_plain(cols: list, seed: int = 0) -> torch.Tensor:
    """Plain version of H31."""
    h = hash64(cols[0], seed)
    for c in cols[1:]:
        h = combine(h, hash64(c, seed))
    return h


def clz64(x: torch.Tensor) -> torch.Tensor:
    """int32 count of leading zeros of u64 values held in int64 (64 for 0;
    no caller in either package): one H32 launch on CUDA."""
    if x.is_cuda:
        return kernels.clz64(x.to(torch.int64).contiguous())
    return clz64_plain(x)


def clz64_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of H32."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_clear = srl64(x, 64 - s) == 0
        n = n + torch.where(top_clear, s, 0)
        x = torch.where(top_clear, x << s, x)
    return (n + (x == 0).to(n.dtype)).to(torch.int32)
