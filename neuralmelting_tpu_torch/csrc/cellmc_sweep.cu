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
// What bounds it on the card: f32 issue in the candidate loop. At the
// north star (cells (8,4,4), K=48, J=16, ~32 atoms a cell, ncyc=2) a
// mover's 27-cell stencil holds ~864 atoms, of which ~65 lie inside
// rc = 2.5 sigma of it; each pair needs two r^2 (~20 operations), and
// the ~10% inside rc also one IEEE divide and ~12 more.
//
// Design: one warp per active cell, each lane one mover. The 27 stencil
// cells' occupied slots form one candidate list of length sum(count)
// (a warp prefix over the 27 counts; slots >= count are never read).
// For J <= 16 a mover has two lanes, lane ji taking the even and lane
// ji + 16 the odd candidates, so every lane works; for J = 17..32 one
// lane walks all of them. The lanes of a half read the same candidate,
// one broadcast load from shared memory, and keep their mover's dE in a
// register: one shuffle joins the two halves and the resolve reads it
// directly. A pair whose new and old r^2 are both >= rc^2 skips the
// divide and the algebra (its term is exactly +0); a mover whose trial
// leaves its cell is rejected whatever its dE, so it skips the loop.
// The replica's slab (3 C K floats, 74 KB at the north star) and counts
// stay in dynamic shared memory for the whole sweep, so device memory
// carries the slab once in and once out; per warp the scratch is the
// stencil's 27 row bases, 81 image shifts and 27 prefix ends (540 B).
// At the north star a CTA is 16 warps (cw = 16) and 82.9 KB: two CTAs
// on an SM. The O(J^2) resolve runs from registers with shuffles, lane
// bi computing the (ai, bi) correction. Built with -fmad=false and IEEE
// division so the per-pair arithmetic and the resolve are the plain
// version's; only the order in which a mover's terms are summed differs.
#include <cuda_runtime.h>

#include <cstdint>

#include "cellmc_common.cuh"
#include "threefry.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
// per-warp scratch, in 4-byte words: 27 neighbour row bases, 27*3 image
// shifts, 27 inclusive prefix ends of the neighbour counts
constexpr int kWarpWords = 27 + 27 * 3 + 27;

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

inline int warps_for(const nm::Geo& g) {
  return g.cw < kMaxWarps ? g.cw : kMaxWarps;
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
  int* wnb = scnt + g.C + warp * kWarpWords;
  float* wsh = reinterpret_cast<float*>(wnb + 27);
  int* wend = reinterpret_cast<int*>(wsh + 27 * 3);
  __shared__ float red_de[kMaxWarps];
  __shared__ int red_acc[kMaxWarps], red_try[kMaxWarps];
  // the replica's params row [beta, dpos, w, L], read once a cell step:
  // volatile keeps it out of the registers the candidate loop needs
  __shared__ float sprm[8];
  volatile float* prm = sprm;

  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * g.rows;
  for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
    sx[i] = gx[base + i];
    sy[i] = gy[base + i];
    sz[i] = gz[base + i];
  }
  for (int i = threadIdx.x; i < g.C; i += blockDim.x)
    scnt[i] = gcount[static_cast<size_t>(r) * g.C + i];
  if (threadIdx.x < 8) sprm[threadIdx.x] = params[r * 8 + threadIdx.x];
  const float eps = pot3[0];
  const float sig2 = pot3[1] * pot3[1];
  const float rc2 = pot3[2] * pot3[2];
  const int tile = r / rt;
  const uint32_t lane_r = static_cast<uint32_t>(r - tile * rt);
  const uint32_t k0 = static_cast<uint32_t>(seeds[2 * tile]);
  const uint32_t k1 = static_cast<uint32_t>(seeds[2 * tile + 1]);
  // this lane's mover ji and its share of the candidate list
  const int nh = J <= 16 ? 2 : 1;
  const int ji = nh == 2 ? (lane & 15) : lane;
  const int half = nh == 2 ? (lane >> 4) : 0;
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
      // --- the stencil: row bases, image shifts, prefix of the counts
      int ncnt = 0;
      if (lane < 27) {
        int d[3];
        float sh[3];
        const float L[3] = {prm[5], prm[6], prm[7]};
        offset27(lane, d);
        const int nb = nm::neighbor(g, cf, d, L, sh);
        wnb[lane] = nb;
        for (int a = 0; a < 3; ++a) wsh[3 * lane + a] = sh[a];
        ncnt = scnt[nb / g.K];
      }
      int incl = ncnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane < 27) wend[lane] = incl;
      const int ncand = __shfl_sync(kFull, incl, 26);
      // --- draws: lane ji < J draws for mover ji of this cell
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
        const float dpos = prm[1];
        const float disp[3] = {dpos * nm::sym16(b0, 0),
                               dpos * nm::sym16(b0, 16),
                               dpos * nm::sym16(b1, 0)};
        incell = lane < cnt;  // valid pick
        for (int a = 0; a < 3; ++a) {
          mn[a] = m[a] + disp[a];
          const float wa = prm[2 + a];
          const float lo = static_cast<float>(cf[a]) * wa;
          incell = incell && (mn[a] >= lo) && (mn[a] < lo + wa);
        }
        lnu = logf(nm::bits_to_u01(a0));
      }
      // this lane's mover: old and trial position, slot, and whether its
      // dE can matter (a trial outside its cell is rejected whatever dE)
      float p[3], q[3];
      for (int a = 0; a < 3; ++a) {
        p[a] = __shfl_sync(kFull, m[a], ji);
        q[a] = __shfl_sync(kFull, mn[a], ji);
      }
      const int pk = __shfl_sync(kFull, pick, ji);
      const bool live =
          ji < J && __shfl_sync(kFull, incell ? 1 : 0, ji) != 0;
      __syncwarp();
      // --- dE against the flattened stencil: candidate t is slot t -
      // wend[o-1] of neighbour o; the own cell (o = 0) comes first, so
      // t == pk is the mover's own old slot (r2o = 0 -> NaN), masked
      float acc = 0.f;
      if (live) {
        int o = 0, tbeg = 0, tend = wend[0], nb = wnb[0];
        float h0 = wsh[0], h1 = wsh[1], h2 = wsh[2];
        for (int t = half; t < ncand; t += nh) {
          while (t >= tend) {
            ++o;
            tbeg = tend;
            tend = wend[o];
            nb = wnb[o];
            h0 = wsh[3 * o];
            h1 = wsh[3 * o + 1];
            h2 = wsh[3 * o + 2];
          }
          const int s = nb + t - tbeg;
          const float c0 = sx[s] + h0;
          const float c1 = sy[s] + h1;
          const float c2 = sz[s] + h2;
          const float e0 = c0 - q[0], e1 = c1 - q[1], e2 = c2 - q[2];
          const float f0 = c0 - p[0], f1 = c1 - p[1], f2 = c2 - p[2];
          const float r2n = e0 * e0 + e1 * e1 + e2 * e2;
          const float r2o = f0 * f0 + f1 * f1 + f2 * f2;
          // beyond rc on both sides ediff is exactly +0
          if ((r2n < rc2 || r2o < rc2) && t != pk)
            acc += ediff(r2n, r2o, sig2, rc2);
        }
      }
      if (nh == 2) acc += __shfl_xor_sync(kFull, acc, 16);
      const float de_me = 4.0f * acc;
      // --- sequential resolve: lane bi supplies the (ai, bi) correction
      const float beta = prm[0];
      bool acc_me = false;
      float de_cell = 0.f;
      int nacc = 0;
      for (int ai = 0; ai < J; ++ai) {
        const float p0 = __shfl_sync(kFull, m[0], ai);
        const float p1 = __shfl_sync(kFull, m[1], ai);
        const float p2 = __shfl_sync(kFull, m[2], ai);
        const float n0 = __shfl_sync(kFull, mn[0], ai);
        const float n1 = __shfl_sync(kFull, mn[1], ai);
        const float n2 = __shfl_sync(kFull, mn[2], ai);
        float term = 0.f;
        if (lane < ai && acc_me) {
          term = pair_e(n0, n1, n2, mn[0], mn[1], mn[2], sig2, rc2) -
                 pair_e(n0, n1, n2, m[0], m[1], m[2], sig2, rc2) -
                 pair_e(p0, p1, p2, mn[0], mn[1], mn[2], sig2, rc2) +
                 pair_e(p0, p1, p2, m[0], m[1], m[2], sig2, rc2);
        }
        float dej = __shfl_sync(kFull, de_me, ai);
        for (int bi = 0; bi < ai; ++bi)
          dej += __shfl_sync(kFull, term, bi);
        const bool in_ai = __shfl_sync(kFull, incell ? 1 : 0, ai) != 0;
        const float lnu_ai = __shfl_sync(kFull, lnu, ai);
        const bool acc_ai = in_ai && (lnu_ai < -beta * eps * dej);
        if (lane == ai) acc_me = acc_ai;
        if (acc_ai) {
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

// dynamic shared memory bytes of the launch
extern "C" int nm_cellmc_sweep_smem(int nx, int ny, int nz, int K) {
  const nm::Geo g = nm::make_geo(nx, ny, nz, K);
  return (3 * g.rows + g.C + warps_for(g) * kWarpWords) * 4;
}

// the kernel's static shared memory (reductions, params row)
extern "C" int nm_cellmc_sweep_static_smem() {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, sweep_kernel);
  return static_cast<int>(a.sharedSizeBytes);
}

extern "C" int nm_cellmc_sweep(float* x, float* y, float* z,
                               const int* count, const float* params,
                               const float* pot3, const int* seeds,
                               float* stats, int R, int nx, int ny, int nz,
                               int K, int J, int ncyc, int rt,
                               void* stream) {
  const nm::Geo g = nm::make_geo(nx, ny, nz, K);
  const int smem = nm_cellmc_sweep_smem(nx, ny, nz, K);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sweep_kernel<<<R, warps_for(g) * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      x, y, z, count, params, pot3, seeds, stats, g, J, ncyc, rt);
  return static_cast<int>(cudaGetLastError());
}
