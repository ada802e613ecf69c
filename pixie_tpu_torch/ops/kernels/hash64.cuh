// The 64-bit hash functions, as __device__ functions: bit for bit
// pixie_tpu/ops/hashing.py's splitmix64 (:22), hash64 (:30) and combine
// (:40), whose plain versions are ops/hashing.py's 64-bit path. H25 (the
// reservoir's priorities) inlines them.
#pragma once

#include <stdint.h>

namespace px {

constexpr unsigned long long kGolden64 = 0x9E3779B97F4A7C15ull;

// SplitMix64 finalizer.
__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  unsigned long long z = x + kGolden64;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// hash64 of a value's u64 word (an int sign-extended, a float's f64 bits)
// under seed 0.
__device__ __forceinline__ unsigned long long hash64(unsigned long long word) {
  return splitmix64(word);
}

// Order-dependent (boost-style) combine.
__device__ __forceinline__ unsigned long long combine64(unsigned long long h1,
                                                        unsigned long long h2) {
  return splitmix64(h1 ^ (h2 + kGolden64 + (h1 << 6) + (h1 >> 2)));
}

}  // namespace px
