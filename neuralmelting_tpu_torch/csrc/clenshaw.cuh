// Chebyshev series by Clenshaw recurrence, in the JAX kernels' operation
// order (neuralmelting_tpu/ops/pallas/cellmc_eam.py: _clenshaw), and the
// EAM functions built on it. The plain PyTorch version is
// ops/cellmc_eam.py: clenshaw. Built with -fmad=false and IEEE division
// and square root, so each value is the plain version's f32 value.
#pragma once

#include <cuda_runtime.h>

namespace nm {

constexpr int kMaxSeries = 64;  // longest series staged in shared memory

// x on [a, b] as the Chebyshev variable t, x clamped into [a, b].
__device__ __forceinline__ float cheb_t(float a, float b, float x) {
  const float xx = fminf(fmaxf(x, a), b);
  return (2.0f * xx - (a + b)) / (b - a);
}

// NS series, series s at c + s * stride with n terms, each at NT points
// t[p], as NS x NT interleaved chains: out[s][p] = series s at t[p]. Each
// step reads a coefficient once for its NT chains. A series shorter than
// n is zero-padded at the top; zero top coefficients keep b1 = b2 = +0,
// so padding leaves every bit as it is. U unrolls the recurrence: 4 for
// one chain, 2 for B3's interleaved chains, which then fit B3's 64
// registers unspilled (ptxas -v; without the pragma they spill 12 B).
template <int NS, int NT, int U>
__device__ __forceinline__ void clenshaw_n(const float* c, int stride, int n,
                                           const float (&t)[NT],
                                           float (&out)[NS][NT]) {
  float t2[NT], b1[NS][NT], b2[NS][NT];
#pragma unroll
  for (int p = 0; p < NT; ++p) {
    t2[p] = 2.0f * t[p];
#pragma unroll
    for (int s = 0; s < NS; ++s) b1[s][p] = b2[s][p] = 0.0f;
  }
#pragma unroll (U)
  for (int i = 0; i < n - 1; ++i) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float k = c[s * stride + n - 1 - i];
#pragma unroll
      for (int p = 0; p < NT; ++p) {
        const float nb = t2[p] * b1[s][p] - b2[s][p] + k;
        b2[s][p] = b1[s][p];
        b1[s][p] = nb;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int p = 0; p < NT; ++p)
      out[s][p] = t[p] * b1[s][p] - b2[s][p] + c[s * stride];
}

// Series c[0..n) on [a, b] at x, x clamped into [a, b].
__device__ __forceinline__ float clenshaw(const float* c, int n, float a,
                                          float b, float x) {
  const float t[1] = {cheb_t(a, b, x)};
  float out[1][1];
  clenshaw_n<1, 1, 4>(c, 0, n, t, out);
  return out[0][0];
}

// F(rho) as the Chebyshev variable of its series in q = sqrt(rho), rho
// clamped to [0, rho_hi].
__device__ __forceinline__ float femb_t(float q_lo, float q_hi, float rho_hi,
                                        float rho) {
  return cheb_t(q_lo, q_hi, sqrtf(fminf(fmaxf(rho, 0.0f), rho_hi)));
}

// Embedding energy F(rho) from its series in q = sqrt(rho).
__device__ __forceinline__ float femb(const float* cf, int nf, float q_lo,
                                      float q_hi, float rho_hi, float rho) {
  const float t[1] = {femb_t(q_lo, q_hi, rho_hi, rho)};
  float out[1][1];
  clenshaw_n<1, 1, 4>(cf, 0, nf, t, out);
  return out[0][0];
}

// dF/drho = (dF/dq) / (2 q), rho clamped to [1e-12, rho_hi].
__device__ __forceinline__ float fembd(const float* cfd, int nf, float q_lo,
                                       float q_hi, float rho_hi, float rho) {
  const float q = sqrtf(fminf(fmaxf(rho, 1e-12f), rho_hi));
  return clenshaw(cfd, nf, q_lo, q_hi, q) / (2.0f * q);
}

}  // namespace nm
