// B3: whole EAM position sweep of cell-confined checkerboard NPT Monte
// Carlo, one CTA per replica.
//
// Replaces the JAX package's Pallas kernel make_eam_sweep_fn.sweep
// (neuralmelting_tpu/ops/pallas/cellmc_eam.py). A sweep is ncyc x 27
// colour steps (stride-3 colours). In each colour step every cell of the
// active colour trials ONE mover:
//   * draws: threefry2x32 keyed per replica tile, counters step*8+0..4
//     (pick, dx, dy, dz, accept), flat index cell*rt + lane — the JAX
//     stream bit for bit; pick = min(int(u cnt), max(cnt-1, 0)), the
//     displacement dpos (2u - 1) per axis;
//   * dE = sum_j [phi(u_new) - phi(u_old)] + sum_j [F(rho_j + drho_j) -
//     F(rho_j)] + F(rho_m + sum_j drho_j) - F(rho_m), drho_j = f_rho(u_new)
//     - f_rho(u_old), over the mover's own cell and its 26 neighbours at
//     the colour-step-start state (Clenshaw series, clenshaw.cuh);
//   * accept when the mover stays inside its cell, its cell is occupied
//     and log(u) < -beta dE; then move it and add drho into the density
//     slab: the mover's own rho and every neighbour slot in the 27 cells.
// Cells of one colour are >= 2 cells apart on some axis, so their 27-cell
// neighbourhoods are disjoint: every mover of a colour step reads and
// writes rows no other mover of that step touches, and a CTA barrier
// between colour steps is the only synchronisation.
//
// What bounds it on the card: f32 issue and latency. Per mover, 27*K
// candidate slots (~15 operations each to reach u_old, u_new), Clenshaw
// recurrences of ~20 terms for the ~7% inside the cutoff (four each) and
// two F evaluations per neighbour whose density changes; 27 dependent
// colour steps per cycle. Shared memory cannot hold the replica: four f32
// slabs of 540 cells x K=32 are 276 KB, above the 227 KB a block may have.
// So the slabs stay in device memory (L1/L2 serve the re-reads: the 27
// cells of one mover are 13.8 KB at K=32) and are updated in place; one
// warp per active cell strides its lanes over a neighbour cell's slots,
// keeps each slot's drho in a per-warp shared scratch (27*K floats) for
// the write-back, and reduces dE by shuffles. Shared memory per CTA is
// (C + warps * (108 + 27 K)) floats: 64 KB at 540 cells, K=32, 16 warps.
// Built with -fmad=false and IEEE division so the per-pair arithmetic is
// the plain version's.
#include <cuda_runtime.h>

#include <cstdint>

#include "cellmc_eam_common.cuh"
#include "clenshaw.cuh"
#include "threefry.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;
constexpr int kWarpTab = 27 + 27 * 3;  // neighbour row bases, image shifts

__host__ __device__ inline int warps_for(int cw) {
  return cw < kMaxWarps ? cw : kMaxWarps;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
eam_sweep_kernel(float* gx, float* gy, float* gz, float* grho,
                 const int* __restrict__ gcount,
                 const float* __restrict__ params,
                 const float* __restrict__ scal,
                 const float* __restrict__ cphi,
                 const float* __restrict__ crho,
                 const float* __restrict__ cf,
                 const int* __restrict__ seeds, float* __restrict__ stats,
                 nm::Geo3 g, int np, int nr, int nf, int ncyc, int rt) {
  extern __shared__ float smem[];
  __shared__ float sc[3][nm::kMaxSeries];
  __shared__ float red_de[kMaxWarps];
  __shared__ int red_acc[kMaxWarps], red_try[kMaxWarps];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* scnt = reinterpret_cast<int*>(smem);
  float* wbase = smem + g.C + warp * (kWarpTab + 27 * g.K);
  int* wnb = reinterpret_cast<int*>(wbase);
  float* wsh = wbase + 27;
  float* wdr = wsh + 27 * 3;

  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * g.rows;
  for (int i = threadIdx.x; i < g.C; i += blockDim.x)
    scnt[i] = gcount[static_cast<size_t>(r) * g.C + i];
  for (int i = threadIdx.x; i < nm::kMaxSeries; i += blockDim.x) {
    sc[0][i] = i < np ? cphi[i] : 0.0f;
    sc[1][i] = i < nr ? crho[i] : 0.0f;
    sc[2][i] = i < nf ? cf[i] : 0.0f;
  }
  const float beta = params[r * 8 + 0];
  const float dpos = params[r * 8 + 1];
  const float w[3] = {params[r * 8 + 2], params[r * 8 + 3],
                      params[r * 8 + 4]};
  const float L[3] = {params[r * 8 + 5], params[r * 8 + 6],
                      params[r * 8 + 7]};
  const float rc2 = scal[0], u_lo = scal[1], u_hi = scal[2];
  const float q_lo = scal[3], q_hi = scal[4], rho_hi = scal[5];
  const int tile = r / rt;
  const uint32_t lane_r = static_cast<uint32_t>(r - tile * rt);
  const uint32_t k0 = static_cast<uint32_t>(seeds[2 * tile]);
  const uint32_t k1 = static_cast<uint32_t>(seeds[2 * tile + 1]);
  __syncthreads();

  float st_de = 0.f;  // lane 0 of each warp: this warp's movers, in order
  int st_acc = 0, st_try = 0;
  for (int step = 0; step < ncyc * 27; ++step) {
    const int color = step % 27;
    const uint32_t ctr = static_cast<uint32_t>(step) * 8u;
    for (int c = warp; c < g.cw; c += nwarps) {  // warp-uniform
      const int cell = color * g.cw + c;
      const size_t row0 = base + static_cast<size_t>(cell) * g.K;
      int cfull[3];
      nm::cell_coords3(g, cell, cfull);
      const int cnt = scnt[cell];
      __syncwarp();
      if (lane < 27) {
        int d[3];
        float sh[3];
        nm::offset27(lane, d);
        wnb[lane] = nm::neighbor3(g, cfull, d, L, sh);
        for (int a = 0; a < 3; ++a) wsh[3 * lane + a] = sh[a];
      }
      // --- draws: lane q < 5 draws uniform q of this cell
      float uq = 0.f;
      if (lane < 5) {
        uint32_t o0, o1;
        nm::threefry2x32(k0, k1, ctr + static_cast<uint32_t>(lane),
                         static_cast<uint32_t>(c) *
                                 static_cast<uint32_t>(rt) + lane_r,
                         &o0, &o1);
        uq = nm::bits_to_u01(o0);
      }
      const float u_pick = __shfl_sync(kFull, uq, 0);
      const float disp[3] = {dpos * (2.0f * __shfl_sync(kFull, uq, 1) - 1.0f),
                             dpos * (2.0f * __shfl_sync(kFull, uq, 2) - 1.0f),
                             dpos * (2.0f * __shfl_sync(kFull, uq, 3) - 1.0f)};
      const float u_acc = __shfl_sync(kFull, uq, 4);
      const int pick = min(static_cast<int>(u_pick * static_cast<float>(cnt)),
                           max(cnt - 1, 0));
      const float m[3] = {gx[row0 + pick], gy[row0 + pick], gz[row0 + pick]};
      const float rho_m = grho[row0 + pick];
      const float mn[3] = {m[0] + disp[0], m[1] + disp[1], m[2] + disp[2]};
      __syncwarp();

      // --- dE against the 27-cell stencil; drho of every slot kept
      float a_pair = 0.f, a_emb = 0.f, a_drho = 0.f;
      for (int o = 0; o < 27; ++o) {
        const size_t nb = base + wnb[o];
        const float h0 = wsh[3 * o], h1 = wsh[3 * o + 1], h2 = wsh[3 * o + 2];
        for (int s = lane; s < g.K; s += 32) {
          float dr = 0.f;
          const float c0 = gx[nb + s] + h0;
          if (c0 < nm::kEamInvalidBelow && !(o == 0 && s == pick)) {
            const float c1 = gy[nb + s] + h1, c2 = gz[nb + s] + h2;
            const float e0 = c0 - m[0], e1 = c1 - m[1], e2 = c2 - m[2];
            const float f0 = c0 - mn[0], f1 = c1 - mn[1], f2 = c2 - mn[2];
            const float uo = e0 * e0 + e1 * e1 + e2 * e2;
            const float un = f0 * f0 + f1 * f1 + f2 * f2;
            float fo = 0.f, po = 0.f, fnw = 0.f, pnw = 0.f;
            if (uo < rc2) {
              fo = nm::clenshaw(sc[1], nr, u_lo, u_hi, uo);
              po = nm::clenshaw(sc[0], np, u_lo, u_hi, uo);
            }
            if (un < rc2) {
              fnw = nm::clenshaw(sc[1], nr, u_lo, u_hi, un);
              pnw = nm::clenshaw(sc[0], np, u_lo, u_hi, un);
            }
            a_pair += pnw - po;
            dr = fnw - fo;
            if (dr != 0.f) {  // F(rho + 0) - F(rho) is exactly 0
              const float rj = grho[nb + s];
              a_emb += nm::femb(sc[2], nf, q_lo, q_hi, rho_hi, rj + dr) -
                       nm::femb(sc[2], nf, q_lo, q_hi, rho_hi, rj);
            }
            a_drho += dr;
          }
          wdr[o * g.K + s] = dr;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        a_pair += __shfl_xor_sync(kFull, a_pair, off);
        a_emb += __shfl_xor_sync(kFull, a_emb, off);
        a_drho += __shfl_xor_sync(kFull, a_drho, off);
      }
      const float de = a_pair + a_emb +
                       nm::femb(sc[2], nf, q_lo, q_hi, rho_hi, rho_m + a_drho) -
                       nm::femb(sc[2], nf, q_lo, q_hi, rho_hi, rho_m);

      // --- Metropolis inside the cell
      bool acc = cnt > 0;
      for (int a = 0; a < 3; ++a) {
        const float lo = static_cast<float>(cfull[a]) * w[a];
        acc = acc && (mn[a] >= lo) && (mn[a] < lo + w[a]);
      }
      acc = acc && (logf(u_acc) < -beta * de);

      // --- apply: the move, then drho into the 27 cells' density rows
      if (acc) {
        if (lane == 0) {
          gx[row0 + pick] = mn[0];
          gy[row0 + pick] = mn[1];
          gz[row0 + pick] = mn[2];
        }
        for (int o = 0; o < 27; ++o) {
          const size_t nb = base + wnb[o];
          for (int s = lane; s < g.K; s += 32) {
            if (o == 0 && s == pick) {
              grho[nb + s] = rho_m + a_drho;
            } else {
              const float dr = wdr[o * g.K + s];
              if (dr != 0.f) grho[nb + s] += dr;
            }
          }
        }
      }
      if (lane == 0) {
        if (acc) {
          st_de += de;
          st_acc += 1;
        }
        st_try += cnt > 0 ? 1 : 0;
      }
    }
    __syncthreads();
  }
  if (lane == 0) {
    red_de[warp] = st_de;
    red_acc[warp] = st_acc;
    red_try[warp] = st_try;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float de = 0.f;
    int na = 0, nt = 0;
    for (int q = 0; q < nwarps; ++q) {
      de += red_de[q];
      na += red_acc[q];
      nt += red_try[q];
    }
    stats[r * 8 + 0] = de;
    stats[r * 8 + 1] = static_cast<float>(na);
    stats[r * 8 + 2] = static_cast<float>(nt);
    for (int q = 3; q < 8; ++q) stats[r * 8 + q] = 0.f;
  }
}

}  // namespace

extern "C" int nm_eam_sweep_smem(int nx, int ny, int nz, int K) {
  const nm::Geo3 g = nm::make_geo3(nx, ny, nz, K);
  return (g.C + warps_for(g.cw) * (kWarpTab + 27 * g.K)) * 4;
}

extern "C" int nm_eam_sweep(float* x, float* y, float* z, float* rho,
                            const int* count, const float* params,
                            const float* scal, const float* cphi,
                            const float* crho, const float* cf,
                            const int* seeds, float* stats, int R, int nx,
                            int ny, int nz, int K, int np, int nr, int nf,
                            int ncyc, int rt, void* stream) {
  const nm::Geo3 g = nm::make_geo3(nx, ny, nz, K);
  const int smem = nm_eam_sweep_smem(nx, ny, nz, K);
  cudaError_t e = cudaFuncSetAttribute(
      eam_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  eam_sweep_kernel<<<R, warps_for(g.cw) * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, y, z, rho, count, params, scal, cphi, crho, cf, seeds, stats, g, np,
      nr, nf, ncyc, rt);
  return static_cast<int>(cudaGetLastError());
}
