// B1: LJ pair-sum pass over the slab state, one CTA per replica.
//
// Replaces the JAX package's Pallas kernel make_total_fn.total
// (neuralmelting_tpu/ops/pallas/cellmc.py:743; kernel :781-849,
// pallas_call :865). Per replica it accumulates
//   out[0] = S12o = sum_{r<rc}   4 (sigma/r)^12    out[1] = S6o (same, ^6)
//   out[2] = S12s = sum_{r<rc/s} 4 (sigma/r)^12    out[3] = S6s
// over every unordered pair once: the own cell's pairs (j > i) and the
// 13 lexicographically positive neighbour offsets (the half stencil).
// The TPU kernel and the plain version count the own cell at weight 1/2
// over ordered pairs with the self pair masked; counting each own-cell
// pair once at weight 1 gives the same terms (the two r^2 of a pair are
// bit for bit equal), summed in another order. combine_sums turns the
// sums into E, W and E(s x) (ops/cellmc.py).
//
// What bounds it on the card: f32 instruction throughput over the
// candidate pairs. At the north star (cells (8,4,4), K=48, ~32 atoms a
// cell) a row sees ~430 half-stencil candidates, of which ~8% lie inside
// max(rc, rc/s). Each
// candidate needs ~9 operations to reach r^2 and the compare, and a walk
// over a list of candidates adds a few more of bookkeeping; a pair inside
// also needs the IEEE divide (a multi-instruction sequence under
// -fmad=false) and ~11 more. Evaluating the divide on every candidate,
// or under a branch that some lane of the warp takes on most
// iterations, spends instruction slots on pairs that add +0; so does
// walking a neighbour cell that lies wholly beyond the cutoff.
//
// Design: the replica's slab (74 KB at the north star) is staged in
// dynamic shared memory; a warp per cell, 16 warps a replica (two CTAs an
// SM, 86 KB each).
//   * Counts: slots [0, count) of a cell are packed and slots [count, K)
//     hold 1e30 (tests/test_torch_sweep_premises.py), so a cell's count is
//     the popcount of one ballot of x < 1e29 per 32 slots; no slot at or
//     beyond a count is read after that. The same pass keeps each cell's
//     bounding box (the least and the greatest coordinate of its atoms on
//     each axis).
//   * Candidates: for each of the cell's movers i in turn, lane o < 14
//     takes stencil cell o: the own cell's slots above i (pairs j > i),
//     or a neighbour's count unless its bounding box lies beyond the
//     cutoff. That test is exact (cellmc_common.cuh, box_gap2): a cell
//     whose box lies at a squared distance >= max(rc^2, rc^2/s^2) holds
//     no pair inside (at the north star, cells 1.27 rc wide, about half
//     of the 13 neighbours should drop out for a mover, an estimate from
//     the geometry). A warp prefix over the 14 counts flattens the rest
//     into one list; the lanes walk it 32 at a time and compute r^2 only;
//     __ballot_sync and __popc prefixes append the r^2 of each pair with
//     r^2 < max(rc^2, rc^2/s^2) to the warp's list in shared memory (64
//     entries). The walk is cellmc_common.cuh's walk_candidates, which
//     B4 shares.
//   * Whenever the list holds 32 or more (a walk step appends at most 32,
//     so it never holds more than 63), the lanes take 32 entries, every
//     lane live: sigma^2 / max(r^2, 1e-12), the powers and the four
//     accumulations, each under its own cutoff; the rest moves to the
//     front. The list carries over from cell to cell and is flushed once
//     more at the end.
// Each lane accumulates its flushes in turn; a shuffle tree, then the
// warps in order, reduce the four sums (repeated calls give the same
// bits). Built with -fmad=false and IEEE division so each pair term is
// the plain version's; only the order of the sums differs.
#include <cuda_runtime.h>

#include "cellmc_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;
constexpr int kBuf = 64;  // list entries of a warp
constexpr int kNoff = 14;
// per-warp shared words: stencil tables (the first candidate's row less
// its list position, image shifts, inclusive prefix ends of the counts)
// and the list of r^2
constexpr int kWarpWords = kNoff + kNoff * 3 + kNoff + kBuf;

// the own cell, then the 13 half-stencil offsets (ops/cellmc_geom.py
// offsets13)
__constant__ int kOff14[kNoff][3] = {
    {0, 0, 0},  {0, 0, 1},  {0, 1, -1}, {0, 1, 0},  {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1},  {1, 1, -1}, {1, 1, 0},  {1, 1, 1}};

__global__ void __launch_bounds__(kWarps * 32, 2)
total_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
             const float* __restrict__ gz, const float* __restrict__ params,
             const float* __restrict__ pot3,
             const float* __restrict__ scale, float* __restrict__ out,
             nm::Geo g) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + g.rows;
  float* sz = sy + g.rows;
  float* sbox = sz + g.rows;  // per cell: least x, y, z, greatest x, y, z
  int* scnt = reinterpret_cast<int*>(sbox + 6 * g.C);
  __shared__ float red[kWarps][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* wbeg = scnt + g.C + warp * kWarpWords;
  float* wsh = reinterpret_cast<float*>(wbeg + kNoff);
  int* wend = reinterpret_cast<int*>(wsh + kNoff * 3);
  float* lr2 = reinterpret_cast<float*>(wend + kNoff);

  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * g.rows;
  for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
    sx[i] = gx[base + i];
    sy[i] = gy[base + i];
    sz[i] = gz[base + i];
  }
  const float L[3] = {params[r * 8 + 5], params[r * 8 + 6],
                      params[r * 8 + 7]};
  const float sig2 = pot3[1] * pot3[1];
  const float rc2 = pot3[2] * pot3[2];
  const float s = scale[r];
  const float rc2s = rc2 / (s * s);
  const float cut = fmaxf(rc2, rc2s);
  __syncthreads();
  // counts (the occupied slots are packed below them) and bounding boxes
  nm::counts_and_boxes(sx, sy, sz, g.C, g.K, warp, kWarps, scnt, sbox);
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int nbuf = 0;
  // the pair terms of the first n (<= 32) listed r^2, then the rest (< 32)
  // to the front
  auto flush = [&](int n) {
    const float r2 = lane < n ? lr2[lane] : 0.f;
    const float rest = lane < nbuf - n ? lr2[n + lane] : 0.f;
    if (lane < n) {
      const float sr2 = sig2 / fmaxf(r2, 1e-12f);
      const float sr6 = sr2 * sr2 * sr2;
      const float q6 = 4.0f * sr6;
      const float q12 = q6 * sr6;
      if (r2 < rc2) {
        acc[0] += q12;
        acc[1] += q6;
      }
      if (r2 < rc2s) {
        acc[2] += q12;
        acc[3] += q6;
      }
    }
    __syncwarp();
    if (lane < nbuf - n) lr2[lane] = rest;
    __syncwarp();
    nbuf -= n;
  };

  for (int cell = warp; cell < g.C; cell += kWarps) {
    const int row0 = cell * g.K;
    const int cnt = scnt[cell];
    // --- lane o < 14: stencil cell o, its row base, count and bounding
    // box at the image the own cell sees it
    int nb = 0, cn = 0;
    float box[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    __syncwarp();  // the previous cell's walks have read the shifts
    if (lane < kNoff) {
      int c[3];
      float sh[3];
      nm::cell_coords(g, cell, c);
      nb = nm::neighbor(g, c, kOff14[lane], L, sh);
      cn = scnt[nb / g.K];
      const float* b = sbox + 6 * (nb / g.K);
      for (int a = 0; a < 3; ++a) {
        wsh[3 * lane + a] = sh[a];
        box[a] = b[a] + sh[a];
        box[3 + a] = b[3 + a] + sh[a];
      }
    }
    // --- each mover i against its candidates
    for (int i = 0; i < cnt; ++i) {
      const float m[3] = {sx[row0 + i], sy[row0 + i], sz[row0 + i]};
      int n = 0, first = nb;
      if (lane == 0) {  // own cell: the slots above i
        n = cnt - i - 1;
        first = nb + i + 1;
      } else if (lane < kNoff && cn > 0 && nm::box_gap2(box, m) < cut) {
        n = cn;
      }
      nm::walk_candidates<kNoff>(
          sx, sy, sz, m, first, n, wbeg, wend, wsh, nbuf,
          // beyond both cutoffs all four terms are exactly +0
          [&](int, float r2) { return r2 < cut; },
          [&](int at, int, float r2) { lr2[at] = r2; }, flush);
    }
  }
  if (nbuf > 0) flush(nbuf);

  float v[4];
  for (int q = 0; q < 4; ++q) {
    v[q] = acc[q];
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_xor_sync(kFull, v[q], off);
  }
  if (lane == 0)
    for (int q = 0; q < 4; ++q) red[warp][q] = v[q];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < 4; ++q) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[w][q];
      out[r * 8 + q] = t;
      out[r * 8 + 4 + q] = 0.f;
    }
  }
}

}  // namespace

// dynamic shared memory bytes of the launch
extern "C" int nm_cellmc_total_smem(int nx, int ny, int nz, int K) {
  const nm::Geo g = nm::make_geo(nx, ny, nz, K);
  return (3 * g.rows + 7 * g.C + kWarps * kWarpWords) * 4;
}

// the kernel's static shared memory (the reduction)
extern "C" int nm_cellmc_total_static_smem() {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, total_kernel);
  return static_cast<int>(a.sharedSizeBytes);
}

extern "C" int nm_cellmc_total(const float* x, const float* y,
                               const float* z, const float* params,
                               const float* pot3, const float* scale,
                               float* out, int R, int nx, int ny, int nz,
                               int K, void* stream) {
  const nm::Geo g = nm::make_geo(nx, ny, nz, K);
  const int smem = nm_cellmc_total_smem(nx, ny, nz, K);
  cudaError_t e = cudaFuncSetAttribute(
      total_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  total_kernel<<<R, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, params, pot3, scale, out, g);
  return static_cast<int>(cudaGetLastError());
}
