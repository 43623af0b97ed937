// B1: LJ pair-sum pass over the slab state, one CTA per replica.
//
// Replaces the JAX package's Pallas kernel make_total_fn.total
// (neuralmelting_tpu/ops/pallas/cellmc.py). Per replica it accumulates
//   out[0] = S12o = sum_{r<rc}   4 (sigma/r)^12    out[1] = S6o (same, ^6)
//   out[2] = S12s = sum_{r<rc/s} 4 (sigma/r)^12    out[3] = S6s
// with every unordered pair once: the own cell at weight 1/2 with the
// self pair masked, plus the 13 lexicographically positive neighbour
// offsets at weight 1 (the half stencil, as the TPU kernel does).
// combine_sums turns these into E, W and E(s x) (ops/cellmc.py).
//
// What bounds it on the card: f32 issue rate. Every pair is ~20 FP32
// operations plus one IEEE divide (a multi-instruction sequence), and the
// slab is read from shared memory, so device memory carries only the
// 3*C*K*4 bytes of each replica once. The design keeps the replica's whole
// slab (74 KB at 128 cells x K=48) in dynamic shared memory, gives each
// thread whole (cell, slot) rows so the pair loop needs no atomics, and
// reduces the four sums per block in a fixed order (the result does not
// vary from run to run). Built with -fmad=false and IEEE division so the
// per-pair arithmetic is the plain version's.
#include <cuda_runtime.h>

#include "cellmc_common.cuh"

namespace {

constexpr int kThreads = 256;

__constant__ int kOff13[13][3] = {
    {0, 0, 1},  {0, 1, -1}, {0, 1, 0},  {0, 1, 1},  {1, -1, -1},
    {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},  {1, 0, 1},
    {1, 1, -1}, {1, 1, 0},  {1, 1, 1}};

__device__ __forceinline__ void pair_sums(float cx, float cy, float cz,
                                          float mx, float my, float mz,
                                          float sig2, float rc2, float rc2s,
                                          float* acc) {
  if (!(cx < nm::kValidBelow)) return;  // empty candidate slot
  const float d0 = cx - mx, d1 = cy - my, d2 = cz - mz;
  const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
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

__global__ void __launch_bounds__(kThreads)
total_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
             const float* __restrict__ gz, const float* __restrict__ params,
             const float* __restrict__ pot3,
             const float* __restrict__ scale, float* __restrict__ out,
             nm::Geo g) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + g.rows;
  float* sz = sy + g.rows;
  __shared__ float red[kThreads / 32][4];

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
  __syncthreads();

  float own[4] = {0.f, 0.f, 0.f, 0.f};
  float oth[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < g.rows; i += blockDim.x) {
    const float mx = sx[i], my = sy[i], mz = sz[i];
    if (!(mx < nm::kValidBelow)) continue;  // empty slot: no pairs
    const int cell = i / g.K;
    const int slot = i - cell * g.K;
    const int row0 = cell * g.K;
    for (int j = 0; j < g.K; ++j) {
      if (j == slot) continue;
      pair_sums(sx[row0 + j], sy[row0 + j], sz[row0 + j], mx, my, mz, sig2,
                rc2, rc2s, own);
    }
    int c[3];
    nm::cell_coords(g, cell, c);
    for (int o = 0; o < 13; ++o) {
      float sh[3];
      const int nb = nm::neighbor(g, c, kOff13[o], L, sh);
      for (int j = 0; j < g.K; ++j) {
        pair_sums(sx[nb + j] + sh[0], sy[nb + j] + sh[1], sz[nb + j] + sh[2],
                  mx, my, mz, sig2, rc2, rc2s, oth);
      }
    }
  }
  float v[4];
  for (int q = 0; q < 4; ++q) {
    v[q] = 0.5f * own[q] + oth[q];
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
    for (int q = 0; q < 4; ++q) red[warp][q] = v[q];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < 4; ++q) {
      float t = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t += red[w][q];
      out[r * 8 + q] = t;
      out[r * 8 + 4 + q] = 0.f;
    }
  }
}

}  // namespace

extern "C" int nm_cellmc_total(const float* x, const float* y,
                               const float* z, const float* params,
                               const float* pot3, const float* scale,
                               float* out, int R, int nx, int ny, int nz,
                               int K, void* stream) {
  const nm::Geo g = nm::make_geo(nx, ny, nz, K);
  const int smem = 3 * g.rows * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      total_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  total_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, params, pot3, scale, out, g);
  return static_cast<int>(cudaGetLastError());
}
