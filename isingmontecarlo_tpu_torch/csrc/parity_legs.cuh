// A slot's toggled legs as a set, for K2's kernels that loop over any
// number of legs (parity_bits.cu, parity_bits_global.cu).
#pragma once

#include <stdint.h>

// Leg k's toggle of the slot at offset `at` of a [K, M, R] leg plane (plane
// = M * R elements): the bit of its variable (word index in *word), or 0 for
// a sentinel (a variable outside [0, N)), an untoggled leg, or a variable
// that an earlier toggled leg of the slot names, so that two legs on one
// variable flip it once, as the plain version's scatter does.
__device__ __forceinline__ uint32_t leg_toggle(const int32_t* __restrict__ v_idx,
                                               const uint8_t* __restrict__ tog, int k,
                                               int64_t plane, int64_t at, int N, int* word) {
  const int64_t i = k * plane + at;
  const int vv = v_idx[i];
  if (!tog[i] || (unsigned)vv >= (unsigned)N) return 0u;
  for (int k2 = 0; k2 < k; ++k2) {
    if (tog[k2 * plane + at] && v_idx[k2 * plane + at] == vv) return 0u;
  }
  *word = vv >> 5;
  return 1u << (vv & 31);
}
