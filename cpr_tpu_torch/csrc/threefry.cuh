// threefry2x32 as a device function, bit for bit the stream of
// `jax.random` under jax_threefry_partitionable=True (kernel K1's core,
// shared by K2 and K3).
//
// Replaces: the XLA lowering of jax.random's threefry2x32 (jax's
// prng.py `threefry_2x32`), called by cpr_tpu at envs/nakamoto.py:124-128,
// envs/base.py:180 and gym/envs.py:68,93,169-175.
//
// Bound: integer ALU. One call is 20 rounds of (add, funnel-shift
// rotate, xor) plus 5 key injections, about 80 32-bit integer operations
// on 16 bytes of input; there is nothing to fetch, so the design keeps
// the whole state in registers and the rotation counts compile-time
// constants (one SHF each).

#pragma once

#include <cstdint>

namespace cpr {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One threefry2x32 block of key (k0, k1) on counter (x0, x1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#define CPR_ROUND(r) \
  x0 += x1;          \
  x1 = rotl32(x1, r) ^ x0;
#define CPR_ROUNDS_A CPR_ROUND(13) CPR_ROUND(15) CPR_ROUND(26) CPR_ROUND(6)
#define CPR_ROUNDS_B CPR_ROUND(17) CPR_ROUND(29) CPR_ROUND(16) CPR_ROUND(24)
  CPR_ROUNDS_A
  x0 += ks[1]; x1 += ks[2] + 1u;
  CPR_ROUNDS_B
  x0 += ks[2]; x1 += ks[0] + 2u;
  CPR_ROUNDS_A
  x0 += ks[0]; x1 += ks[1] + 3u;
  CPR_ROUNDS_B
  x0 += ks[1]; x1 += ks[2] + 4u;
  CPR_ROUNDS_A
  x0 += ks[2]; x1 += ks[0] + 5u;
#undef CPR_ROUNDS_B
#undef CPR_ROUNDS_A
#undef CPR_ROUND
  return make_uint2(x0, x1);
}

// jax.random.split(key, n)[i] and fold_in(key, i): counter (0, i).
__device__ __forceinline__ uint2 split_key(uint2 key, uint32_t i) {
  return threefry2x32(key.x, key.y, 0u, i);
}

// 32 random bits of element j of a draw from `key` (x0 ^ x1).
__device__ __forceinline__ uint32_t random_bits(uint2 key, uint32_t j) {
  const uint2 b = threefry2x32(key.x, key.y, 0u, j);
  return b.x ^ b.y;
}

// jax.random.uniform's float32 on [0, 1): exact, no rounding involved.
__device__ __forceinline__ float uniform_of_bits(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// jax.random.exponential: -log1p(-u); log1pf may differ from XLA's by ULPs.
__device__ __forceinline__ float exponential_of_bits(uint32_t bits) {
  return -log1pf(-uniform_of_bits(bits));
}

// jax.random.gumbel in mode "low" (float32): -log(-log(u)) of
// u = uniform(minval=tiny, maxval=1) = max(tiny, f * (1 - tiny) + tiny),
// where 1 - tiny rounds to 1. logf may differ from XLA's log by an ULP.
__device__ __forceinline__ float gumbel_of_bits(uint32_t bits) {
  const float tiny = 1.17549435e-38f;  // FLT_MIN
  const float u = fmaxf(tiny, __fadd_rn(uniform_of_bits(bits), tiny));
  return -logf(-logf(u));
}

// jax.random.uniform's float64 on [0, 1) in 64-bit mode: the 64-bit bits
// are (x0 << 32) | x1 of one block; their top 52 bits are the mantissa.
__device__ __forceinline__ double uniform64_of_words(uint2 x) {
  const uint64_t bits = ((uint64_t)x.x << 32) | x.y;
  return __longlong_as_double((long long)((bits >> 12) |
                                          0x3FF0000000000000ULL)) - 1.0;
}

// jax.random.exponential in float64: -log1p(-u); log1p may differ from
// XLA's by an ULP.
__device__ __forceinline__ double exponential64_of_words(uint2 x) {
  return -log1p(-uniform64_of_words(x));
}

}  // namespace cpr
