// Chebyshev series by Clenshaw recurrence, in the JAX kernels' operation
// order (neuralmelting_tpu/ops/pallas/cellmc_eam.py: _clenshaw), and the
// EAM functions built on it. The plain PyTorch version is
// ops/cellmc_eam.py: clenshaw. Built with -fmad=false and IEEE division
// and square root, so each value is the plain version's f32 value.
#pragma once

#include <cuda_runtime.h>

namespace nm {

constexpr int kMaxSeries = 64;  // longest series staged in shared memory

// Series c[0..n) on [a, b] at x, x clamped into [a, b].
__device__ __forceinline__ float clenshaw(const float* c, int n, float a,
                                          float b, float x) {
  const float xx = fminf(fmaxf(x, a), b);
  const float t = (2.0f * xx - (a + b)) / (b - a);
  const float t2 = 2.0f * t;
  float b1 = 0.0f, b2 = 0.0f;
  for (int i = 0; i < n - 1; ++i) {
    const float nb = t2 * b1 - b2 + c[n - 1 - i];
    b2 = b1;
    b1 = nb;
  }
  return t * b1 - b2 + c[0];
}

// Embedding energy F(rho) from its series in q = sqrt(rho), rho clamped
// to [0, rho_hi].
__device__ __forceinline__ float femb(const float* cf, int nf, float q_lo,
                                      float q_hi, float rho_hi, float rho) {
  const float q = sqrtf(fminf(fmaxf(rho, 0.0f), rho_hi));
  return clenshaw(cf, nf, q_lo, q_hi, q);
}

// dF/drho = (dF/dq) / (2 q), rho clamped to [1e-12, rho_hi].
__device__ __forceinline__ float fembd(const float* cfd, int nf, float q_lo,
                                       float q_hi, float rho_hi, float rho) {
  const float q = sqrtf(fminf(fmaxf(rho, 1e-12f), rho_hi));
  return clenshaw(cfd, nf, q_lo, q_hi, q) / (2.0f * q);
}

}  // namespace nm
