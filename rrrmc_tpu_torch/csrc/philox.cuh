// Philox4x32-10 (Salmon et al., Random123), the same function as
// rrrmc_tpu_torch/ops/prng.py::philox4x32_10. Stream layout (see prng.py):
// key = (seed, global chain id), counter = (word index, move, draw id, 0).
#pragma once
#include <cstdint>

namespace rrrmc {

constexpr uint32_t DRAW_RACE = 0;
constexpr uint32_t DRAW_ACCEPT = 1;
constexpr uint32_t DRAW_SKIP = 2;
constexpr uint32_t DRAW_SITE = 0;
constexpr uint32_t DRAW_SWEEP = 3;
constexpr uint32_t DRAW_SK = 4;
constexpr uint32_t DRAW_EO_RANK = 5;
constexpr uint32_t DRAW_EO_TIE = 6;
constexpr uint32_t DRAW_REPLICA_SWEEP = 7;
constexpr uint32_t DRAW_CLASS = 8;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// word 0 of counter (0, move, draw, 0), as the int32 bits the kernels use
__device__ __forceinline__ int32_t draw_bits(uint32_t seed, uint32_t chain,
                                             uint32_t move, uint32_t draw) {
  return (int32_t)philox4x32_10(make_uint4(0u, move, draw, 0u),
                                make_uint2(seed, chain)).x;
}

// int32 bits -> u = bits * 2^-32 + 1/2 (built with -fmad=false, so this is
// the same two roundings as the torch version)
__device__ __forceinline__ float to_uniform(int32_t bits) {
  return __int2float_rn(bits) * 2.3283064365386963e-10f + 0.5f;
}

}  // namespace rrrmc
