// B4: full EAM energy pass over the slab state at isotropic scale s, one
// CTA per replica.
//
// Replaces the JAX package's Pallas kernel make_eam_total_fn.total
// (neuralmelting_tpu/ops/pallas/cellmc_eam.py:351; kernel :378-534,
// pallas_call :550). With u = (r s)^2:
//   phase 1, per atom i: rho_i = sum_j f_rho(u_ij) over the 27-cell
//     stencil, the pair energy 1/2 sum phi(u), with the virial 1/2 sum
//     2u phi'(u), and F(rho_i); the rho slab and, with the virial,
//     F'(rho_i) are written;
//   phase 2 (virial only, after a CTA barrier): the embedding virial
//     1/2 sum (F'_i + F'_j) 2u f_rho'(u), every ordered pair.
// stats = [E_pair + E_emb, -(W_pair + W_emb), E_pair, E_emb, 0, W_pair,
// W_emb, 0] (W = sum r f, the repo's sign), as the TPU kernel writes them.
// The TPU kernel's mover chunks and grouped recurrences are VMEM and
// latency devices of that chip; what carries over is the per-pair f32
// arithmetic (Clenshaw in the JAX order, clenshaw.cuh).
//
// What bounds it on the card: the latency of the dependent Clenshaw
// chains, and lanes with nothing to do. At scripts/eambench.py's cells
// (15,6,6) there are ~7.6 atoms a cell and ~205 in a 27-cell stencil, of
// which ~7% (12-14) lie inside rc. Walking all 27 K slots of a stencil
// for each of a cell's K rows (a thread per row) makes the time grow with
// K^2 rather than with the atoms, leaves most lanes of a warp empty, and
// runs each series with one or two lanes live.
//
// Design: a warp per cell, 16 warps a replica, in a fixed assignment.
//   * Counts: slots [0, count) of a cell are packed and slots [count, K)
//     hold 1e30 (tests/test_torch_sweep_premises.py holds this after bin,
//     rebin and rescale), so a cell's count is the popcount of one ballot
//     of x < 1e29 per 32 slots. The same pass keeps each cell's bounding
//     box (the least and the greatest coordinate of its atoms on each
//     axis). Counts and boxes go to device memory the wrapper allocates
//     (`work`), read after a CTA barrier, so that no shared memory grows
//     with the cells; no slot at or beyond a count is read after that.
//   * Candidates: for each of the cell's movers in turn, lane o < 27
//     takes stencil cell o: its count, unless its bounding box lies
//     outside rc. That test is exact (cellmc_common.cuh, box_gap2: the
//     box's squared distance times s^2 is <= u of every pair in the cell;
//     at eambench's cells, 1.14 rc wide, about 10 of the 27 should drop
//     out for a mover, an estimate from the geometry). A warp
//     prefix over the 27 counts flattens the rest into one list; the
//     lanes walk it 32 at a time and compute u only; __ballot_sync and
//     __popc prefixes append (mover, row, u) of each candidate inside rc
//     to the warp's list in shared memory. The walk is
//     cellmc_common.cuh's walk_candidates, which B1 shares.
//   * The list holds 64 entries: it is flushed whenever it holds 32 or
//     more (one walk step appends at most 32, so it never holds more than
//     63), and once more at the end of the cell. A flush takes 32 entries,
//     one a lane, every lane live: phi and f_rho (and phi') as interleaved
//     Clenshaw chains. The list is in mover order, so each mover's f_rho
//     terms are a run of lanes: a segmented warp scan leaves the run's sum
//     on its last lane, which adds it to the mover's density in shared
//     memory. The rest of the list moves to its front.
//   * F(rho) (and F') of a cell's atoms come from its lanes after its last
//     flush; phase 2 walks the same occupied candidates again and flushes
//     (F'_i + F'_j) 2u f_rho'(u) on the compacted list. F' lives in
//     `work` after the counts and boxes (written in phase 1, read in
//     phase 2 after the barrier).
// Every sum runs in an order fixed by the geometry and the data (lanes
// accumulate their flushes in turn, then a shuffle tree, then the warps
// in order), never by atomics: repeated calls give the same bits. Shared
// memory, per warp: 1188 B of stencil tables, 768 B of list and 4 K B of
// densities (33 KB at eambench's K=32, 37 KB at the runner's largest
// K=96); it does not grow with the cells, so the geometry is bounded
// only by K.
// Built with -fmad=false and IEEE division and square root so each
// per-pair value is the plain version's; only the order of the sums
// differs.
#include <cuda_runtime.h>

#include "cellmc_common.cuh"
#include "cellmc_eam_common.cuh"
#include "clenshaw.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;
constexpr int kBuf = 64;  // list entries of a warp
// per-warp stencil tables: a row base per list position, image shifts,
// bounding boxes, inclusive prefix ends of the counts
constexpr int kWarpTab = 27 + 27 * 3 + 27 * 6 + 27;

// per-warp shared words: stencil tables, the list (mover, row, u), the
// densities of the cell's movers
__host__ __device__ inline int warp_words(int K) {
  return kWarpTab + 3 * kBuf + K;
}

// words of device memory a replica takes: per cell a count and a box,
// with the virial F' of every slot
__host__ __device__ inline int work_words(const nm::Geo3& g, bool virial) {
  return 7 * g.C + (virial ? g.rows : 0);
}

struct List {
  int* beg;    // stencil: first candidate's row less its list position
  float* sh;   // stencil: image shifts
  float* box;  // stencil: least x, y, z, greatest x, y, z, at the image
  int* end;    // stencil: inclusive prefix ends of the counts
  int* m;      // listed pairs: mover slot
  int* row;    // listed pairs: candidate row
  float* u;    // listed pairs: u = (r s)^2
  float* rho;  // the cell's densities, one a mover slot
  int n;       // listed pairs
};

// Lane o < 27: stencil cell o of a cell, the own cell first.
struct Stencil {
  int nb;  // row base
  int cn;  // count
};

// Stencil cell `lane` of `cell`; its image shift and its bounding box at
// that image go to the warp's tables.
__device__ __forceinline__ Stencil stencil27(const nm::Geo3& g, int cell,
                                             const int* scnt,
                                             const float* sbox,
                                             const float* L, List& l,
                                             int lane) {
  Stencil st{0, 0};
  __syncwarp();  // the previous cell's walks have read the tables
  if (lane < 27) {
    int c[3], d[3];
    float sh[3];
    nm::cell_coords3(g, cell, c);
    nm::offset27(lane, d);
    st.nb = nm::neighbor3(g, c, d, L, sh);
    st.cn = scnt[st.nb / g.K];
    const float* b = sbox + 6 * (st.nb / g.K);
    for (int a = 0; a < 3; ++a) {
      l.sh[3 * lane + a] = sh[a];
      l.box[6 * lane + a] = b[a] + sh[a];
      l.box[6 * lane + 3 + a] = b[3 + a] + sh[a];
    }
  }
  return st;
}

// Drops the first n (<= 32) listed pairs and moves the rest (< 32) to the
// front.
__device__ __forceinline__ void drop(List& l, int n, int lane) {
  const int rest = l.n - n;
  int m = 0, row = 0;
  float u = 0.f;
  if (lane < rest) {
    m = l.m[n + lane];
    row = l.row[n + lane];
    u = l.u[n + lane];
  }
  __syncwarp();
  if (lane < rest) {
    l.m[lane] = m;
    l.row[lane] = row;
    l.u[lane] = u;
  }
  __syncwarp();
  l.n = rest;
}

// Lists (m, row, u) of every candidate of mover slot m (of the cell at
// row0) inside rc, on cellmc_common.cuh's walk_candidates; row row0 + m
// is the mover itself.
template <class Flush>
__device__ __forceinline__ void walk(const float* __restrict__ x,
                                     const float* __restrict__ y,
                                     const float* __restrict__ z, int row0,
                                     int m, const Stencil& st, float s2,
                                     float rc2, List& l, int lane,
                                     Flush&& flush) {
  const float mp[3] = {x[row0 + m], y[row0 + m], z[row0 + m]};
  int n = 0;
  if (lane < 27 && st.cn > 0 &&
      nm::box_gap2(l.box + 6 * lane, mp) * s2 < rc2)
    n = st.cn;
  const int self = row0 + m;
  nm::walk_candidates<27>(
      x, y, z, mp, st.nb, n, l.beg, l.end, l.sh, l.n,
      // outside rc every term of the pair is exactly +0
      [&](int row, float r2) { return r2 * s2 < rc2 && row != self; },
      [&](int at, int row, float r2) {
        l.m[at] = m;
        l.row[at] = row;
        l.u[at] = r2 * s2;
      },
      flush);
}

template <bool V>
__global__ void __launch_bounds__(kWarps * 32, 2)
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
                 float* __restrict__ rho_out, float* work, nm::Geo3 g,
                 int np, int nr, int nf) {
  extern __shared__ int smem[];
  __shared__ float sc[6][nm::kMaxSeries];
  __shared__ float red[kWarps][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * g.rows;
  // the replica's words of `work`: per cell its bounding box (least,
  // greatest) and its count, then (with the virial) F' of every slot
  float* wk = work + static_cast<size_t>(r) * work_words(g, V);
  float* sbox = wk;
  int* scnt = reinterpret_cast<int*>(wk + 6 * g.C);
  float* f = wk + 7 * g.C;
  List l;
  l.beg = smem + warp * warp_words(g.K);
  l.sh = reinterpret_cast<float*>(l.beg + 27);
  l.box = l.sh + 27 * 3;
  l.end = reinterpret_cast<int*>(l.box + 27 * 6);
  l.m = l.end + 27;
  l.row = l.m + kBuf;
  l.u = reinterpret_cast<float*>(l.row + kBuf);
  l.rho = l.u + kBuf;
  l.n = 0;

  const float* x = gx + base;
  const float* y = gy + base;
  const float* z = gz + base;
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
  const int ns = np > nr ? np : nr;  // phi, phi', f_rho: one padded length
  const float L[3] = {params[r * 8 + 5], params[r * 8 + 6],
                      params[r * 8 + 7]};
  const float s = scale[r];
  const float s2 = s * s;
  // counts (the occupied slots are packed below them) and bounding boxes
  nm::counts_and_boxes(x, y, z, g.C, g.K, warp, kWarps, scnt, sbox);
  __syncthreads();

  // ---- phase 1: densities, pair energy (+ pair virial), F(rho) --------
  float e_phi = 0.f, w_phi = 0.f, e_emb = 0.f, w_emb = 0.f;
  for (int cell = warp; cell < g.C; cell += kWarps) {
    const int row0 = cell * g.K;
    const int cnt = scnt[cell];
    for (int m = lane; m < cnt; m += 32) l.rho[m] = 0.f;
    __syncwarp();
    const Stencil st = stencil27(g, cell, scnt, sbox, L, l, lane);
    auto flush = [&](int n) {
      const bool live = lane < n;
      const float u = live ? l.u[lane] : u_lo;
      const int mi = live ? l.m[lane] : -1;
      const float t[1] = {nm::cheb_t(u_lo, u_hi, u)};
      float f_rho;
      if constexpr (V) {
        float v[3][1];  // phi, phi', f_rho
        nm::clenshaw_n<3, 1, 2>(sc[0], nm::kMaxSeries, ns, t, v);
        f_rho = v[2][0];
        if (live) {
          e_phi += v[0][0];
          w_phi += 2.0f * u * v[1][0];
        }
      } else {
        float v[2][1];  // phi, f_rho
        nm::clenshaw_n<2, 1, 4>(sc[0], 2 * nm::kMaxSeries, ns, t, v);
        f_rho = v[1][0];
        if (live) e_phi += v[0][0];
      }
      // the list is in mover order: a segmented scan over the runs of
      // equal mi leaves each run's sum on its last lane
      float sum = live ? f_rho : 0.f;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, sum, off);
        const int mo = __shfl_up_sync(kFull, mi, off);
        if (lane >= off && mo == mi) sum += v;
      }
      const int next = __shfl_down_sync(kFull, mi, 1);
      if (live && (lane == n - 1 || next != mi)) l.rho[mi] += sum;
      __syncwarp();
      drop(l, n, lane);
    };
    for (int m = 0; m < cnt; ++m)
      walk(x, y, z, row0, m, st, s2, rc2, l, lane, flush);
    if (l.n > 0) flush(l.n);
    for (int m = lane; m < g.K; m += 32) {
      float rho_i = 0.f, fpi = 0.f;
      if (m < cnt) {
        rho_i = l.rho[m];
        e_emb += nm::femb(sc[4], nf, q_lo, q_hi, rho_hi, rho_i);
        if (V) fpi = nm::fembd(sc[5], nf, q_lo, q_hi, rho_hi, rho_i);
      }
      rho_out[base + row0 + m] = rho_i;
      if (V) f[row0 + m] = fpi;
    }
    __syncwarp();
  }

  // ---- phase 2: embedding virial, every F' of phase 1 needed -----------
  if (V) {
    __syncthreads();
    for (int cell = warp; cell < g.C; cell += kWarps) {
      const int row0 = cell * g.K;
      const int cnt = scnt[cell];
      const Stencil st = stencil27(g, cell, scnt, sbox, L, l, lane);
      auto flush = [&](int n) {
        const bool live = lane < n;
        const float u = live ? l.u[lane] : u_lo;
        const float rhod = nm::clenshaw(sc[3], nr, u_lo, u_hi, u);
        if (live) {
          const float coef = f[row0 + l.m[lane]] + f[l.row[lane]];
          w_emb += coef * 2.0f * u * rhod;
        }
        __syncwarp();
        drop(l, n, lane);
      };
      for (int m = 0; m < cnt; ++m)
        walk(x, y, z, row0, m, st, s2, rc2, l, lane, flush);
      if (l.n > 0) flush(l.n);
    }
  }

  // ---- block reduction in a fixed order --------------------------------
  float v[4] = {e_phi, w_phi, e_emb, w_emb};
  for (int q = 0; q < 4; ++q)
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_xor_sync(kFull, v[q], off);
  if (lane == 0)
    for (int q = 0; q < 4; ++q) red[warp][q] = v[q];
  __syncthreads();
  if (threadIdx.x == 0) {
    float t[4];
    for (int q = 0; q < 4; ++q) {
      t[q] = 0.f;
      for (int w = 0; w < kWarps; ++w) t[q] += red[w][q];
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

template <bool V>
int static_bytes() {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, eam_total_kernel<V>);
  return static_cast<int>(a.sharedSizeBytes);
}

template <bool V>
int launch(const float* x, const float* y, const float* z,
           const float* params, const float* scal, const float* cphi,
           const float* cphid, const float* crho, const float* crhod,
           const float* cf, const float* cfd, const float* scale,
           float* stats, float* rho, float* work, int R, const nm::Geo3& g,
           int smem, int np, int nr, int nf, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      eam_total_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  eam_total_kernel<V><<<R, kWarps * 32, smem, stream>>>(
      x, y, z, params, scal, cphi, cphid, crho, crhod, cf, cfd, scale, stats,
      rho, work, g, np, nr, nf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dynamic shared memory bytes of the launch (no term in the cells)
extern "C" int nm_eam_total_smem(int K) { return kWarps * warp_words(K) * 4; }

// words of the device scratch `work` a replica takes
extern "C" int nm_eam_total_work_words(int nx, int ny, int nz, int K,
                                       int with_virial) {
  return work_words(nm::make_geo3(nx, ny, nz, K), with_virial != 0);
}

// static shared memory bytes of the kernel (the larger instantiation)
extern "C" int nm_eam_total_static_smem() {
  const int a = static_bytes<true>(), b = static_bytes<false>();
  return a > b ? a : b;
}

extern "C" int nm_eam_total(const float* x, const float* y, const float* z,
                            const float* params, const float* scal,
                            const float* cphi, const float* cphid,
                            const float* crho, const float* crhod,
                            const float* cf, const float* cfd,
                            const float* scale, float* stats, float* rho,
                            float* work, int R, int nx, int ny, int nz,
                            int K, int np, int nr, int nf, int with_virial,
                            void* stream) {
  const nm::Geo3 g = nm::make_geo3(nx, ny, nz, K);
  const int smem = nm_eam_total_smem(K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_virial
             ? launch<true>(x, y, z, params, scal, cphi, cphid, crho, crhod,
                            cf, cfd, scale, stats, rho, work, R, g, smem, np,
                            nr, nf, st)
             : launch<false>(x, y, z, params, scal, cphi, cphid, crho, crhod,
                             cf, cfd, scale, stats, rho, work, R, g, smem, np,
                             nr, nf, st);
}
