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
// What bounds it on the card: f32 latency of the Clenshaw chains. At
// scripts/eambench.py's configuration (cells (15,6,6), ~7.6 atoms a
// cell, K=16 at set-up and 32 in the chunk) a mover's 27 cells hold ~205
// atoms, of which ~7% (12-14) lie inside rc; each of those needs four
// dependent series of ~20 terms (phi and f_rho at u_old and u_new) and
// two F evaluations, and 27 dependent colour steps make a cycle. With a
// lane per slot the warp would run the series at almost every offset
// with one or two lanes live.
//
// Design: one warp per cell of a colour (up to 32, so eambench's 20
// cells take one round), in three passes over a per-warp list:
//   1. the 27 cells' occupied slots form one candidate list of length
//      sum(count) (a warp prefix over the counts; slots >= count are never
//      read); the lanes walk it 32 at a time and compute u_old and u_new
//      only; __ballot_sync and __popc prefixes append (row, u_old, u_new)
//      of each candidate inside rc on either side to the warp's list;
//   2. the lanes take the list 32 entries at a time, every lane live:
//      phi and f_rho at u_old and u_new as four interleaved Clenshaw
//      chains, F(rho_j + drho_j) and F(rho_j) as two; drho replaces u_old
//      in the list;
//   3. on accept, grho += drho only on the listed slots (elsewhere drho is
//      0 and there was no write before either), and the mover's own rho is
//      set. Each slot still takes exactly one += drho: the slab is the
//      plain version's bit for bit.
// A mover whose trial leaves its cell (or whose cell is empty) is
// rejected whatever its dE, so its warp skips passes 1-2. Shared memory
// cannot hold the replica (four f32 slabs of 540 cells x K=32 are 276
// KB), so the slabs stay in device memory, updated in place. The list is
// sized for the worst case, every candidate in range: 27 K entries of 3
// words, plus 135 words of stencil tables, per warp. At eambench's cells
// (C = 540, cw = 20) and K=32 that is 10.9 KB a warp and 220 KB for 20
// warps with the counts and 1.2 KB of static shared memory, within the
// 227 KB a block may take. Where the warps of a colour would not fit the
// CTA takes fewer warps, W = (227 KB - static - 4 C) / (4 (135 + 81 K)),
// and a colour step runs a second round over its cells: at these cells
// from K >= 34 (K = 40: W = 16 for 20 cells). The runner grows K by 8 on
// a slot overflow, up to 96 (W = 7). Phi and f_rho run as one loop of
// four interleaved chains, F as two (clenshaw.cuh's clenshaw_n). Built
// with -fmad=false and IEEE division so the per-pair arithmetic is the
// plain version's; only the order in which a mover's terms are summed
// differs.
#include <cuda_runtime.h>

#include <cstdint>

#include "cellmc_eam_common.cuh"
#include "clenshaw.cuh"
#include "threefry.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
// per-warp stencil tables: neighbour row bases, image shifts, inclusive
// prefix ends of the neighbour counts
constexpr int kWarpTab = 27 + 27 * 3 + 27;
// shared memory a block may take on this card, static and dynamic
constexpr int kBlockSmem = 232448;

inline int warp_words(const nm::Geo3& g) { return kWarpTab + 3 * 27 * g.K; }

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
  // the replica's params row [beta, dpos, w, L], read once a cell step:
  // volatile keeps it out of the registers the passes need
  __shared__ float sprm[8];
  volatile float* prm = sprm;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cap = 27 * g.K;  // list entries: every candidate in range
  int* scnt = reinterpret_cast<int*>(smem);
  int* wnb = scnt + g.C + warp * (kWarpTab + 3 * cap);
  float* wsh = reinterpret_cast<float*>(wnb + 27);
  int* wend = reinterpret_cast<int*>(wsh + 27 * 3);
  int* lrow = wend + 27;                              // listed slot rows
  float* lua = reinterpret_cast<float*>(lrow + cap);  // u_old, then drho
  float* lub = lua + cap;                             // u_new
  const unsigned below = (1u << lane) - 1u;

  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * g.rows;
  for (int i = threadIdx.x; i < g.C; i += blockDim.x)
    scnt[i] = gcount[static_cast<size_t>(r) * g.C + i];
  for (int i = threadIdx.x; i < nm::kMaxSeries; i += blockDim.x) {
    sc[0][i] = i < np ? cphi[i] : 0.0f;
    sc[1][i] = i < nr ? crho[i] : 0.0f;
    sc[2][i] = i < nf ? cf[i] : 0.0f;
  }
  if (threadIdx.x < 8) sprm[threadIdx.x] = params[r * 8 + threadIdx.x];
  const float rc2 = scal[0], u_lo = scal[1], u_hi = scal[2];
  const float q_lo = scal[3], q_hi = scal[4], rho_hi = scal[5];
  const int ns = np > nr ? np : nr;  // phi and f_rho, one padded length
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
      // --- the stencil: row bases, image shifts, prefix of the counts
      int ncnt = 0;
      if (lane < 27) {
        int d[3];
        float sh[3];
        const float L[3] = {prm[5], prm[6], prm[7]};
        nm::offset27(lane, d);
        const int nb = nm::neighbor3(g, cfull, d, L, sh);
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
      const float dpos = prm[1];
      const float disp[3] = {dpos * (2.0f * __shfl_sync(kFull, uq, 1) - 1.0f),
                             dpos * (2.0f * __shfl_sync(kFull, uq, 2) - 1.0f),
                             dpos * (2.0f * __shfl_sync(kFull, uq, 3) - 1.0f)};
      const float u_acc = __shfl_sync(kFull, uq, 4);
      const int pick = min(static_cast<int>(u_pick * static_cast<float>(cnt)),
                           max(cnt - 1, 0));
      const float m[3] = {gx[row0 + pick], gy[row0 + pick], gz[row0 + pick]};
      const float rho_m = grho[row0 + pick];
      const float mn[3] = {m[0] + disp[0], m[1] + disp[1], m[2] + disp[2]};
      // a trial outside its cell, or in an empty cell, is rejected
      // whatever its dE (warp-uniform)
      bool live = cnt > 0;
      for (int a = 0; a < 3; ++a) {
        const float wa = prm[2 + a];
        const float lo = static_cast<float>(cfull[a]) * wa;
        live = live && (mn[a] >= lo) && (mn[a] < lo + wa);
      }
      __syncwarp();

      float de = 0.f, a_drho = 0.f;
      int nlist = 0;
      if (live) {
        // --- pass 1: u_old, u_new of every candidate; candidate t is slot
        // t - wend[o-1] of neighbour o, the own cell (o = 0) first, so t ==
        // pick is the mover itself
        int o = 0, tbeg = 0, tend = wend[0], nb = wnb[0];
        float h0 = wsh[0], h1 = wsh[1], h2 = wsh[2];
        for (int t0 = 0; t0 < ncand; t0 += 32) {
          const int t = t0 + lane;
          bool in = false;
          int row = 0;
          float uo = 0.f, un = 0.f;
          if (t < ncand) {
            while (t >= tend) {
              ++o;
              tbeg = tend;
              tend = wend[o];
              nb = wnb[o];
              h0 = wsh[3 * o];
              h1 = wsh[3 * o + 1];
              h2 = wsh[3 * o + 2];
            }
            row = nb + t - tbeg;
            const float c0 = gx[base + row] + h0;
            const float c1 = gy[base + row] + h1;
            const float c2 = gz[base + row] + h2;
            const float e0 = c0 - m[0], e1 = c1 - m[1], e2 = c2 - m[2];
            const float f0 = c0 - mn[0], f1 = c1 - mn[1], f2 = c2 - mn[2];
            uo = e0 * e0 + e1 * e1 + e2 * e2;
            un = f0 * f0 + f1 * f1 + f2 * f2;
            // outside rc on both sides every term is exactly 0
            in = (uo < rc2 || un < rc2) && t != pick;
          }
          const unsigned ball = __ballot_sync(kFull, in);
          if (in) {
            const int at = nlist + __popc(ball & below);
            lrow[at] = row;
            lua[at] = uo;
            lub[at] = un;
          }
          nlist += __popc(ball);
        }
        __syncwarp();
        // --- pass 2: the series on the list, every lane live
        float a_pair = 0.f, a_emb = 0.f;
        for (int i = lane; i < nlist; i += 32) {
          const float uo = lua[i], un = lub[i];
          // phi and f_rho (sc[0], sc[1]), at uo and at un: one loop of ns
          // terms
          const float tu[2] = {nm::cheb_t(u_lo, u_hi, uo),
                               nm::cheb_t(u_lo, u_hi, un)};
          float v[2][2];
          nm::clenshaw_n<2, 2, 2>(sc[0], nm::kMaxSeries, ns, tu, v);
          const float fo = uo < rc2 ? v[1][0] : 0.f;
          const float po = uo < rc2 ? v[0][0] : 0.f;
          const float fnw = un < rc2 ? v[1][1] : 0.f;
          const float pnw = un < rc2 ? v[0][1] : 0.f;
          a_pair += pnw - po;
          const float dr = fnw - fo;
          const float rj = grho[base + lrow[i]];
          // F(rho_j + drho_j) and F(rho_j)
          const float tq[2] = {nm::femb_t(q_lo, q_hi, rho_hi, rj + dr),
                               nm::femb_t(q_lo, q_hi, rho_hi, rj)};
          float f[1][2];
          nm::clenshaw_n<1, 2, 2>(sc[2], 0, nf, tq, f);
          const float demb = f[0][0] - f[0][1];
          if (dr != 0.f) a_emb += demb;  // F(rho + 0) - F(rho) is 0
          a_drho += dr;
          lua[i] = dr;
        }
        for (int off = 16; off > 0; off >>= 1) {
          a_pair += __shfl_xor_sync(kFull, a_pair, off);
          a_emb += __shfl_xor_sync(kFull, a_emb, off);
          a_drho += __shfl_xor_sync(kFull, a_drho, off);
        }
        de = a_pair + a_emb +
             nm::femb(sc[2], nf, q_lo, q_hi, rho_hi, rho_m + a_drho) -
             nm::femb(sc[2], nf, q_lo, q_hi, rho_hi, rho_m);
      }

      // --- Metropolis inside the cell
      const bool acc = live && (logf(u_acc) < -prm[0] * de);

      // --- pass 3: the move, then drho into the listed density slots
      if (acc) {
        if (lane == 0) {
          gx[row0 + pick] = mn[0];
          gy[row0 + pick] = mn[1];
          gz[row0 + pick] = mn[2];
          grho[row0 + pick] = rho_m + a_drho;
        }
        for (int i = lane; i < nlist; i += 32) {
          const float dr = lua[i];
          if (dr != 0.f) grho[base + lrow[i]] += dr;
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

// the kernel's static shared memory (series, reductions, params row)
int static_bytes() {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, eam_sweep_kernel);
  return static_cast<int>(a.sharedSizeBytes);
}

// a warp per cell of a colour, as many as the block's shared memory holds
int warps_for(const nm::Geo3& g) {
  const int fit =
      (kBlockSmem - static_bytes() - g.C * 4) / (warp_words(g) * 4);
  const int want = g.cw < kMaxWarps ? g.cw : kMaxWarps;
  return want < fit ? want : (fit > 1 ? fit : 1);
}

}  // namespace

// dynamic shared memory bytes of the launch
extern "C" int nm_eam_sweep_smem(int nx, int ny, int nz, int K) {
  const nm::Geo3 g = nm::make_geo3(nx, ny, nz, K);
  return (g.C + warps_for(g) * warp_words(g)) * 4;
}

extern "C" int nm_eam_sweep_static_smem() { return static_bytes(); }

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
  eam_sweep_kernel<<<R, warps_for(g) * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, y, z, rho, count, params, scal, cphi, crho, cf, seeds, stats, g, np,
      nr, nf, ncyc, rt);
  return static_cast<int>(cudaGetLastError());
}
