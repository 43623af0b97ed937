// Threefry-2x32, 20 rounds (Random123; the generator JAX uses), on uint32.
//
// The same stream as the in-kernel generator of the JAX package's sweep
// kernel (neuralmelting_tpu/ops/pallas/cellmc.py: threefry2x32,
// _bits_to_u01 and sym16) and as the plain torch version in
// neuralmelting_tpu_torch/ops/rng.py. Unsigned adds wrap exactly like the
// JAX int32 adds, and >> is the logical shift the JAX code asks for.
#pragma once

#include <cstdint>

namespace nm {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[4 * (i % 2) + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

// 23 random bits -> f32 uniform in (0, 1]; never 0, so log() is safe.
__device__ __forceinline__ float bits_to_u01(uint32_t b) {
  return static_cast<float>((b & 0x7fffffu) + 1u) * 1.1920928955078125e-07f;
}

// 16-bit field at bit sh -> symmetric f32 in (-1, 1): +-(2m+1)/65536.
__device__ __forceinline__ float sym16(uint32_t b, int sh) {
  return (static_cast<float>((b >> sh) & 0xffffu) - 32767.5f) *
         (1.0f / 32768.0f);
}

}  // namespace nm
