// Philox4x32-10 (Salmon et al., SC'11) with Random123's constants: the
// counter-based generator of kernel K1 in all of its variants
// (checkerboard.cu, checkerboard_bands.cu, checkerboard_tiles.cu,
// checkerboard_global.cu), equal bit for bit to
// ops/checkerboard.py::philox4x32.
#pragma once

#include <stdint.h>

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The ten rounds' keys, (k0, k1) bumped by the Weyl constants, computed on
// the host. Passed to a kernel by value as a __grid_constant__ argument, the
// rounds read them from the constant bank as operands, which saves the 18
// key additions of every call of philox4x32_10 above.
struct PhiloxKeys {
  uint32_t k[20];
};

inline PhiloxKeys philox_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys keys;
  for (int r = 0; r < 10; ++r) {
    keys.k[2 * r] = k0 + (uint32_t)r * kPhiloxW0;
    keys.k[2 * r + 1] = k1 + (uint32_t)r * kPhiloxW1;
  }
  return keys;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const PhiloxKeys& keys) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ keys.k[2 * r], lo1, hi0 ^ c.w ^ keys.k[2 * r + 1], lo0);
  }
  return c;
}

// The acceptance threshold of table entry p: (bits >> 8) * 2^-24 < p exactly
// when (bits >> 8) < ceil(p * 2^24) (p * 2^24 is exact, a power-of-two
// scaling).
__device__ __forceinline__ uint32_t accept_threshold(float p) {
  constexpr float kTwo24 = 16777216.0f;
  const float q = __fmul_rn(p, kTwo24);
  return q >= kTwo24 ? 1u << 24 : q > 0.0f ? (uint32_t)ceilf(q) : 0u;
}
