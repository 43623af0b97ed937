// B2: whole position sweep of cell-confined checkerboard NPT Monte Carlo,
// one CTA per replica.
//
// Replaces the JAX package's Pallas kernel make_sweep_fn.sweep
// (neuralmelting_tpu/ops/pallas/cellmc.py). A sweep is ncyc x 8 colour
// steps. In each colour step every cell of the active colour trials J
// consecutive movers (from a random start slot), each displaced by a
// 16-bit symmetric proposal inside its own cell:
//   * draws: threefry2x32 keyed per replica tile, counters step*8+0/1,
//     flat index (ji*cw + c)*rt + lane — the JAX stream bit for bit;
//   * dE of each mover against its own cell and the 26 neighbour cells at
//     the colour-step-start positions, with the shared-reciprocal
//     e(new) - e(old) of the JAX kernel (one divide per pair);
//   * confinement: the trial must stay inside [c w, (c+1) w) on each axis;
//   * a sequential resolve over the J movers that corrects mover ai's dE
//     exactly for every earlier accepted cell-mate bi, then Metropolis.
// Same-colour cells never share a stencil, so all cells of a colour run
// in parallel with exact acceptance.
//
// What bounds it on the card: f32 issue rate in the candidate loop,
// 27*K pairs per mover with ~30 FP32 operations and one IEEE divide each
// (at 128 cells x K=48, J=16, two cycles: ~5.3M pair terms per replica per
// sweep). The design keeps the replica's slab (74 KB there) and counts in
// dynamic shared memory for the whole sweep, so device memory carries the
// slab once in and once out; one warp per active cell strides its lanes
// over a neighbour cell's slots (consecutive lanes, consecutive shared
// addresses: no bank conflicts) and reduces each mover's dE by shuffles;
// the O(J^2) resolve runs from registers with shuffles, lane bi computing
// the (ai, bi) correction. Built with -fmad=false and IEEE division so the
// per-pair arithmetic and the resolve are the plain version's.
#include <cuda_runtime.h>

#include <cstdint>

#include "cellmc_common.cuh"
#include "threefry.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;
constexpr int kMaxJ = 32;
// per-warp scratch, in 4-byte words: mover old/new coords (6*32), dE (32),
// 27 neighbour row bases, 27*3 image shifts
constexpr int kWarpWords = 7 * kMaxJ + 27 + 27 * 3;

__device__ __forceinline__ float ediff(float r2n, float r2o, float sig2,
                                       float rc2) {
  const float q = sig2 / (r2n * r2o);
  const float s2n = q * r2o, s2o = q * r2n;
  const float s6n = s2n * s2n * s2n, s6o = s2o * s2o * s2o;
  const float en = (r2n < rc2) ? (s6n * s6n - s6n) : 0.0f;
  const float eo = (r2o < rc2) ? (s6o * s6o - s6o) : 0.0f;
  return en - eo;
}

__device__ __forceinline__ float pair_e(float p0, float p1, float p2,
                                        float q0, float q1, float q2,
                                        float sig2, float rc2) {
  const float d0 = p0 - q0, d1 = p1 - q1, d2 = p2 - q2;
  const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
  const float sr2 = sig2 / r2;
  const float sr6 = sr2 * sr2 * sr2;
  return 4.0f * ((r2 < rc2) ? (sr6 * sr6 - sr6) : 0.0f);
}

__device__ __forceinline__ void offset27(int o, int* d) {
  // [(0,0,0)] + the 26 others in lexicographic order (the JAX order)
  if (o == 0) {
    d[0] = d[1] = d[2] = 0;
    return;
  }
  int q = o - 1;
  if (q >= 13) q += 1;  // skip (0,0,0), lexicographic index 13
  d[0] = q / 9 - 1;
  d[1] = (q / 3) % 3 - 1;
  d[2] = q % 3 - 1;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
sweep_kernel(float* __restrict__ gx, float* __restrict__ gy,
             float* __restrict__ gz, const int* __restrict__ gcount,
             const float* __restrict__ params,
             const float* __restrict__ pot3, const int* __restrict__ seeds,
             float* __restrict__ stats, nm::Geo g, int J, int ncyc, int rt) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + g.rows;
  float* sz = sy + g.rows;
  int* scnt = reinterpret_cast<int*>(sz + g.rows);
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wm = reinterpret_cast<float*>(scnt + g.C) + warp * kWarpWords;
  float* wmn = wm + 3 * kMaxJ;
  float* wde = wmn + 3 * kMaxJ;
  int* wnb = reinterpret_cast<int*>(wde + kMaxJ);
  float* wsh = reinterpret_cast<float*>(wnb + 27);
  __shared__ float red_de[kMaxWarps];
  __shared__ int red_acc[kMaxWarps], red_try[kMaxWarps];

  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * g.rows;
  for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
    sx[i] = gx[base + i];
    sy[i] = gy[base + i];
    sz[i] = gz[base + i];
  }
  for (int i = threadIdx.x; i < g.C; i += blockDim.x)
    scnt[i] = gcount[static_cast<size_t>(r) * g.C + i];
  const float beta = params[r * 8 + 0];
  const float dpos = params[r * 8 + 1];
  const float w[3] = {params[r * 8 + 2], params[r * 8 + 3],
                      params[r * 8 + 4]};
  const float L[3] = {params[r * 8 + 5], params[r * 8 + 6],
                      params[r * 8 + 7]};
  const float eps = pot3[0];
  const float sig2 = pot3[1] * pot3[1];
  const float rc2 = pot3[2] * pot3[2];
  const int tile = r / rt;
  const uint32_t lane_r = static_cast<uint32_t>(r - tile * rt);
  const uint32_t k0 = static_cast<uint32_t>(seeds[2 * tile]);
  const uint32_t k1 = static_cast<uint32_t>(seeds[2 * tile + 1]);
  __syncthreads();

  float st_de = 0.f;  // lane 0 of each warp: this warp's cells, in order
  int st_acc = 0, st_try = 0;
  for (int step = 0; step < ncyc * 8; ++step) {
    const int color = step & 7;
    const uint32_t ctr = static_cast<uint32_t>(step) * 8u;
    for (int c = warp; c < g.cw; c += nwarps) {  // warp-uniform
      const int cell = color * g.cw + c;
      const int row0 = cell * g.K;
      int cf[3];
      nm::cell_coords(g, cell, cf);
      const int cnt = scnt[cell];
      __syncwarp();
      if (lane < 27) {
        int d[3];
        float sh[3];
        offset27(lane, d);
        wnb[lane] = nm::neighbor(g, cf, d, L, sh);
        for (int a = 0; a < 3; ++a) wsh[3 * lane + a] = sh[a];
      }
      // --- draws: lane ji is mover ji of this cell
      uint32_t a0 = 0, a1 = 0, b0 = 0, b1 = 0;
      if (lane < J) {
        const uint32_t flat =
            (static_cast<uint32_t>(lane * g.cw + c)) *
                static_cast<uint32_t>(rt) + lane_r;
        nm::threefry2x32(k0, k1, ctr, flat, &a0, &a1);
        nm::threefry2x32(k0, k1, ctr + 1u, flat, &b0, &b1);
      }
      const float u0 = nm::bits_to_u01(__shfl_sync(kFull, a1, 0));
      const int s0 = min(static_cast<int>(u0 * static_cast<float>(cnt)),
                         max(cnt - 1, 0));
      int pick = 0;
      bool incell = false;
      float lnu = 0.f, m[3] = {0.f, 0.f, 0.f}, mn[3] = {0.f, 0.f, 0.f};
      if (lane < J) {
        const int raw = s0 + lane;
        pick = raw >= cnt ? raw - cnt : raw;
        m[0] = sx[row0 + pick];
        m[1] = sy[row0 + pick];
        m[2] = sz[row0 + pick];
        const float disp[3] = {dpos * nm::sym16(b0, 0),
                               dpos * nm::sym16(b0, 16),
                               dpos * nm::sym16(b1, 0)};
        incell = lane < cnt;  // valid pick
        for (int a = 0; a < 3; ++a) {
          mn[a] = m[a] + disp[a];
          const float lo = static_cast<float>(cf[a]) * w[a];
          incell = incell && (mn[a] >= lo) && (mn[a] < lo + w[a]);
          wm[a * kMaxJ + lane] = m[a];
          wmn[a * kMaxJ + lane] = mn[a];
        }
        lnu = logf(nm::bits_to_u01(a0));
      }
      __syncwarp();
      // --- dE of each mover against the 27-cell stencil
      for (int ai = 0; ai < J; ++ai) {
        const float p0 = wm[ai], p1 = wm[kMaxJ + ai], p2 = wm[2 * kMaxJ + ai];
        const float n0 = wmn[ai], n1 = wmn[kMaxJ + ai],
                    n2 = wmn[2 * kMaxJ + ai];
        const int pk = __shfl_sync(kFull, pick, ai);
        float acc = 0.f;
        for (int o = 0; o < 27; ++o) {
          const int nb = wnb[o];
          const float h0 = wsh[3 * o], h1 = wsh[3 * o + 1],
                      h2 = wsh[3 * o + 2];
          for (int s = lane; s < g.K; s += 32) {
            const float c0 = sx[nb + s] + h0;
            const float c1 = sy[nb + s] + h1;
            const float c2 = sz[nb + s] + h2;
            const float e0 = c0 - n0, e1 = c1 - n1, e2 = c2 - n2;
            const float f0 = c0 - p0, f1 = c1 - p1, f2 = c2 - p2;
            const float r2n = e0 * e0 + e1 * e1 + e2 * e2;
            const float r2o = f0 * f0 + f1 * f1 + f2 * f2;
            // the mover's own old slot (r2o = 0 -> NaN) is masked
            if (!(o == 0 && s == pk)) acc += ediff(r2n, r2o, sig2, rc2);
          }
        }
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kFull, acc, off);
        if (lane == 0) wde[ai] = 4.0f * acc;
      }
      __syncwarp();
      // --- sequential resolve: lane bi supplies the (ai, bi) correction
      bool acc_me = false;
      float de_cell = 0.f;
      int nacc = 0;
      for (int ai = 0; ai < J; ++ai) {
        float term = 0.f;
        if (lane < ai && acc_me) {
          const float p0 = wm[ai], p1 = wm[kMaxJ + ai],
                      p2 = wm[2 * kMaxJ + ai];
          const float n0 = wmn[ai], n1 = wmn[kMaxJ + ai],
                      n2 = wmn[2 * kMaxJ + ai];
          term = pair_e(n0, n1, n2, mn[0], mn[1], mn[2], sig2, rc2) -
                 pair_e(n0, n1, n2, m[0], m[1], m[2], sig2, rc2) -
                 pair_e(p0, p1, p2, mn[0], mn[1], mn[2], sig2, rc2) +
                 pair_e(p0, p1, p2, m[0], m[1], m[2], sig2, rc2);
        }
        float dej = wde[ai];
        for (int bi = 0; bi < ai; ++bi)
          dej += __shfl_sync(kFull, term, bi);
        const bool in_ai = __shfl_sync(kFull, incell ? 1 : 0, ai) != 0;
        const float lnu_ai = __shfl_sync(kFull, lnu, ai);
        const bool acc = in_ai && (lnu_ai < -beta * eps * dej);
        if (lane == ai) acc_me = acc;
        if (acc) {
          de_cell += eps * dej;
          nacc += 1;
        }
      }
      __syncwarp();
      // --- apply the accepted moves (picks of valid movers are distinct)
      if (lane < J && acc_me) {
        sx[row0 + pick] = mn[0];
        sy[row0 + pick] = mn[1];
        sz[row0 + pick] = mn[2];
      }
      st_de += de_cell;
      st_acc += nacc;
      st_try += min(cnt, J);
    }
    __syncthreads();
  }
  if (lane == 0) {
    red_de[warp] = st_de;
    red_acc[warp] = st_acc;
    red_try[warp] = st_try;
  }
  for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
    gx[base + i] = sx[i];
    gy[base + i] = sy[i];
    gz[base + i] = sz[i];
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

extern "C" int nm_cellmc_sweep_smem(int nx, int ny, int nz, int K) {
  const nm::Geo g = nm::make_geo(nx, ny, nz, K);
  const int nwarps = g.cw < kMaxWarps ? g.cw : kMaxWarps;
  return (3 * g.rows + g.C + nwarps * kWarpWords) * 4;
}

extern "C" int nm_cellmc_sweep(float* x, float* y, float* z,
                               const int* count, const float* params,
                               const float* pot3, const int* seeds,
                               float* stats, int R, int nx, int ny, int nz,
                               int K, int J, int ncyc, int rt,
                               void* stream) {
  const nm::Geo g = nm::make_geo(nx, ny, nz, K);
  const int nwarps = g.cw < kMaxWarps ? g.cw : kMaxWarps;
  const int smem = nm_cellmc_sweep_smem(nx, ny, nz, K);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sweep_kernel<<<R, nwarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, count, params, pot3, seeds, stats, g, J, ncyc, rt);
  return static_cast<int>(cudaGetLastError());
}
