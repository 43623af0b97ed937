// B4: full EAM energy pass over the slab state at isotropic scale s, one
// CTA per replica.
//
// Replaces the JAX package's Pallas kernel make_eam_total_fn.total
// (neuralmelting_tpu/ops/pallas/cellmc_eam.py). With u = (r s)^2:
//   phase 1, per atom i: rho_i = sum_j f_rho(u_ij) over the 27-cell
//     stencil (per offset a sum over K, offsets in the JAX order), the
//     pair energy 1/2 sum phi(u), with the virial 1/2 sum 2u phi'(u), and
//     F(rho_i); the rho slab and, with the virial, F'(rho_i) are written;
//   phase 2 (virial only, after a barrier): the embedding virial
//     1/2 sum (F'_i + F'_j) 2u f_rho'(u), every ordered pair.
// stats = [E_pair + E_emb, -(W_pair + W_emb), E_pair, E_emb, 0, W_pair,
// W_emb, 0] (W = sum r f, the repo's sign), as the TPU kernel writes them.
// The TPU kernel's mover chunks (mch) and grouped recurrences are VMEM and
// latency devices of that chip; what carries over is the per-pair f32
// arithmetic (Clenshaw in the JAX order, clenshaw.cuh).
//
// What bounds it on the card: f32 issue in the candidate loop. Each atom
// scans 27*K candidate slots (~10 operations to reach u < rc^2); the ~7%
// inside the cutoff cost 2-3 Clenshaw recurrences of ~20 terms each
// (~3 operations per term). Device memory carries the 3*C*K coordinates
// once in (the candidate reads hit L1/L2: a replica's slab is <= 200 KB)
// and the rho slab once out. The design gives each thread whole
// (cell, slot) rows, accumulates in registers in a fixed order and
// reduces each block in a fixed order (repeated calls give the same
// bits); the F' slab of phase 2 lives in device memory the wrapper
// allocates, so no shared-memory limit bounds the geometry.
#include <cuda_runtime.h>

#include "cellmc_eam_common.cuh"
#include "clenshaw.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
eam_total_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                 const float* __restrict__ gz,
                 const float* __restrict__ params,
                 const float* __restrict__ scal,
                 const float* __restrict__ cphi,
                 const float* __restrict__ cphid,
                 const float* __restrict__ crho,
                 const float* __restrict__ crhod,
                 const float* __restrict__ cf, const float* __restrict__ cfd,
                 const float* __restrict__ scale, float* __restrict__ stats,
                 float* __restrict__ rho_out, float* fp, nm::Geo3 g, int np,
                 int nr, int nf, int with_virial) {
  __shared__ float sc[6][nm::kMaxSeries];
  __shared__ float red[kThreads / 32][4];
  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * g.rows;
  for (int i = threadIdx.x; i < nm::kMaxSeries; i += blockDim.x) {
    sc[0][i] = i < np ? cphi[i] : 0.0f;
    sc[1][i] = i < np ? cphid[i] : 0.0f;
    sc[2][i] = i < nr ? crho[i] : 0.0f;
    sc[3][i] = i < nr ? crhod[i] : 0.0f;
    sc[4][i] = i < nf ? cf[i] : 0.0f;
    sc[5][i] = i < nf ? cfd[i] : 0.0f;
  }
  const float rc2 = scal[0], u_lo = scal[1], u_hi = scal[2];
  const float q_lo = scal[3], q_hi = scal[4], rho_hi = scal[5];
  const float L[3] = {params[r * 8 + 5], params[r * 8 + 6],
                      params[r * 8 + 7]};
  const float s = scale[r];
  const float s2 = s * s;
  __syncthreads();

  // ---- phase 1: densities, pair energy (+ pair virial), F(rho) --------
  float e_phi = 0.f, w_phi = 0.f, e_emb = 0.f, w_emb = 0.f;
  for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
    const float mx = gx[base + i], my = gy[base + i], mz = gz[base + i];
    float rho_i = 0.f;
    if (mx < nm::kEamInvalidBelow) {
      const int cell = i / g.K;
      const int slot = i - cell * g.K;
      int c[3];
      nm::cell_coords3(g, cell, c);
      for (int o = 0; o < 27; ++o) {
        int d[3];
        float sh[3];
        nm::offset27(o, d);
        const size_t nb = base + nm::neighbor3(g, c, d, L, sh);
        float part = 0.f;
        for (int j = 0; j < g.K; ++j) {
          if (o == 0 && j == slot) continue;
          const float cx = gx[nb + j] + sh[0];
          if (!(cx < nm::kEamInvalidBelow)) continue;
          const float d0 = cx - mx;
          const float d1 = (gy[nb + j] + sh[1]) - my;
          const float d2 = (gz[nb + j] + sh[2]) - mz;
          const float u = (d0 * d0 + d1 * d1 + d2 * d2) * s2;
          if (!(u < rc2)) continue;
          part += nm::clenshaw(sc[2], nr, u_lo, u_hi, u);
          e_phi += nm::clenshaw(sc[0], np, u_lo, u_hi, u);
          if (with_virial)
            w_phi += 2.0f * u * nm::clenshaw(sc[1], np, u_lo, u_hi, u);
        }
        rho_i += part;
      }
      e_emb += nm::femb(sc[4], nf, q_lo, q_hi, rho_hi, rho_i);
      if (with_virial)
        fp[base + i] = nm::fembd(sc[5], nf, q_lo, q_hi, rho_hi, rho_i);
    } else if (with_virial) {
      fp[base + i] = 0.f;
    }
    rho_out[base + i] = rho_i;
  }

  // ---- phase 2: embedding virial, every F' of phase 1 needed -----------
  if (with_virial) {
    __syncthreads();
    for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
      const float mx = gx[base + i], my = gy[base + i], mz = gz[base + i];
      if (!(mx < nm::kEamInvalidBelow)) continue;
      const float fpi = fp[base + i];
      const int cell = i / g.K;
      const int slot = i - cell * g.K;
      int c[3];
      nm::cell_coords3(g, cell, c);
      for (int o = 0; o < 27; ++o) {
        int d[3];
        float sh[3];
        nm::offset27(o, d);
        const size_t nb = base + nm::neighbor3(g, c, d, L, sh);
        for (int j = 0; j < g.K; ++j) {
          if (o == 0 && j == slot) continue;
          const float cx = gx[nb + j] + sh[0];
          if (!(cx < nm::kEamInvalidBelow)) continue;
          const float d0 = cx - mx;
          const float d1 = (gy[nb + j] + sh[1]) - my;
          const float d2 = (gz[nb + j] + sh[2]) - mz;
          const float u = (d0 * d0 + d1 * d1 + d2 * d2) * s2;
          if (!(u < rc2)) continue;
          const float coef = fpi + fp[nb + j];
          w_emb += coef * 2.0f * u * nm::clenshaw(sc[3], nr, u_lo, u_hi, u);
        }
      }
    }
  }

  // ---- block reduction in a fixed order --------------------------------
  float v[4] = {e_phi, w_phi, e_emb, w_emb};
  for (int q = 0; q < 4; ++q)
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
    for (int q = 0; q < 4; ++q) red[warp][q] = v[q];
  __syncthreads();
  if (threadIdx.x == 0) {
    float t[4];
    for (int q = 0; q < 4; ++q) {
      t[q] = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t[q] += red[w][q];
    }
    const float e_pair = 0.5f * t[0], w_pair = 0.5f * t[1];
    const float w_e = 0.5f * t[3];
    float* st = stats + r * 8;
    st[0] = e_pair + t[2];
    st[1] = -(w_pair + w_e);
    st[2] = e_pair;
    st[3] = t[2];
    st[4] = 0.f;
    st[5] = w_pair;
    st[6] = w_e;
    st[7] = 0.f;
  }
}

}  // namespace

extern "C" int nm_eam_total(const float* x, const float* y, const float* z,
                            const float* params, const float* scal,
                            const float* cphi, const float* cphid,
                            const float* crho, const float* crhod,
                            const float* cf, const float* cfd,
                            const float* scale, float* stats, float* rho,
                            float* fp, int R, int nx, int ny, int nz, int K,
                            int np, int nr, int nf, int with_virial,
                            void* stream) {
  const nm::Geo3 g = nm::make_geo3(nx, ny, nz, K);
  eam_total_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, params, scal, cphi, cphid, crho, crhod, cf, cfd, scale, stats,
      rho, fp, g, np, nr, nf, with_virial);
  return static_cast<int>(cudaGetLastError());
}
