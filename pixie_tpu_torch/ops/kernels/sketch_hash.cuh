// The u32 hash functions of the sketches, as __device__ functions: one
// definition for the hash kernel, H5 (HLL), H6 (count-min) and the cell
// lane's H20 and H21. Bit for bit pixie_tpu/ops/hashing.py's u32 path
// (u32_words, mix32, hash32, hash32_pair, clz32): a value hashes as its
// 64-bit word, lo = the low 32 bits, hi = the high 32 bits.
#pragma once

#include <stdint.h>

namespace px {

// murmur3 fmix32.
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t hash32(unsigned long long word, uint32_t seed) {
  const uint32_t lo = (uint32_t)word, hi = (uint32_t)(word >> 32);
  return mix32(lo ^ mix32(hi, 0x9E3779B9u ^ seed), 0x85EBCA77u ^ seed);
}

// The two independent hashes of Kirsch-Mitzenmacher double hashing.
__device__ __forceinline__ uint2 hash32_pair(unsigned long long word, uint32_t seed) {
  const uint32_t lo = (uint32_t)word, hi = (uint32_t)(word >> 32);
  uint2 h;
  h.x = mix32(lo ^ mix32(hi, 0x9E3779B9u ^ seed), 0x85EBCA77u ^ seed);
  h.y = mix32(hi ^ mix32(lo, 0xC2B2AE35u ^ seed), 0x27D4EB2Fu ^ seed);
  return h;
}

// Leading zeros of a u32 (32 for 0).
__device__ __forceinline__ int clz32(uint32_t x) { return __clz((int)x); }

}  // namespace px
