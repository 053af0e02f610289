// Device helpers shared by the port's kernels: Threefry-2x32 and the
// Mersenne-31 arithmetic of the tree MAC.  Bit-exact twins of the plain
// torch functions in repro_torch/kernels/common.py (and of the Pallas
// helpers in src/repro/kernels/common.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kP31 = 0x7FFFFFFFu;
constexpr uint32_t kPosMix = 0x9E3779B1u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define REPRO_TF_ROUND(r) \
  x0 += x1;               \
  x1 = rotl32(x1, r);     \
  x1 ^= x0;

// Threefry-2x32 with 20 rounds: rotations 13,15,26,6 / 17,29,16,24 and a
// key injection after every 4 rounds.  (x0, x1) is the counter in, the
// two keystream words out.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  REPRO_TF_ROUND(17) REPRO_TF_ROUND(29) REPRO_TF_ROUND(16) REPRO_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  REPRO_TF_ROUND(13) REPRO_TF_ROUND(15) REPRO_TF_ROUND(26) REPRO_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
}

#undef REPRO_TF_ROUND

// --- Mersenne-31 (p = 2^31 - 1), lazily reduced ---------------------------

__device__ __forceinline__ uint32_t fold32(uint32_t x) {
  return (x >> 31) + (x & kP31);
}

__device__ __forceinline__ uint32_t canon(uint32_t x) {
  x = fold32(fold32(x));
  return x == kP31 ? 0u : x;
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  return fold32(fold32(fold32(a)) + fold32(fold32(b)));
}

// Exact (a * b) mod p, result < 2^31 + 8: a 64-bit product and two folds.
// Any exact residue gives the same canonical tag as the reference's
// 16-bit-limb mulmod.
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  uint64_t p = static_cast<uint64_t>(a) * b;
  p = (p & kP31) + (p >> 31);
  p = (p & kP31) + (p >> 31);
  return static_cast<uint32_t>(p);
}

}  // namespace repro
