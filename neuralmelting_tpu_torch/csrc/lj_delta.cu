// B5: brute-force minimum-image LJ energy and virial changes of trial
// moves, one CTA per (replica, mover).
//
// Replaces the JAX package's Pallas kernel delta_moves_pallas
// (neuralmelting_tpu/ops/pallas/lj_kernel.py). For mover m of replica r,
// with d = mover - atom under the minimum image (rintf: half to even, as
// jnp.round) and r2 = dx dx + dy dy + dz dz,
//   dE[r, m] = sum_{j != id, r2 < rc2} e(new) - sum e(old)
//   dW[r, m] = the same sums of the pair virial w = r f
// with sr2 = sigma^2 / max(r2, 1e-4), sr6 = sr2 sr2 sr2, sr12 = sr6 sr6,
// e = 4 eps (sr12 - sr6), w = 24 eps (2 sr12 - sr6): LJCut.pair_e_w's
// operations in its order. Built with -fmad=false and IEEE division, so
// each pair term has the plain version's bits; the sums over N are taken
// per thread in index order, then by a butterfly over the warp and over
// the warps in a fixed order, so a result does not vary from run to run.
//
// What bounds it on the card: a CTA streams its replica's N positions
// (12 N bytes) once and does ~33 f32 operations per atom and side, so at
// the batched shape (R=64, N=4096, M=32) it is bound by operations
// (17 MFLOP per replica against 49 KB). The serial engine launches it at
// R=1, M=1, N=256: one CTA, 256 threads, one atom each, where launch
// latency is all that shows. A simple correct kernel: threads stride over
// N, and each reads its atom straight from device memory (L2 serves the
// M movers of a replica).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Pot {
  float sig2, rc2, e4, w24;
};

__device__ __forceinline__ void pair(float mx, float my, float mz, float px,
                                     float py, float pz, float bx, float by,
                                     float bz, const Pot& p, float& e,
                                     float& w) {
  float dx = mx - px, dy = my - py, dz = mz - pz;
  dx = dx - bx * rintf(dx / bx);
  dy = dy - by * rintf(dy / by);
  dz = dz - bz * rintf(dz / bz);
  const float r2 = dx * dx + dy * dy + dz * dz;
  if (r2 < p.rc2) {
    const float sr2 = p.sig2 / fmaxf(r2, 1e-4f);
    const float sr6 = sr2 * sr2 * sr2;
    const float sr12 = sr6 * sr6;
    e += p.e4 * (sr12 - sr6);
    w += p.w24 * (2.0f * sr12 - sr6);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ pos, const float* __restrict__ box,
             const int* __restrict__ ids, const float* __restrict__ oldr,
             const float* __restrict__ newr, float* __restrict__ out, int n,
             int m, int rm_total, Pot p) {
  const int rm = blockIdx.x;
  const int r = rm / m;
  const float* q = pos + static_cast<size_t>(r) * n * 3;
  const float bx = box[3 * r], by = box[3 * r + 1], bz = box[3 * r + 2];
  const int id = ids[rm];
  const float ox = oldr[3 * rm], oy = oldr[3 * rm + 1], oz = oldr[3 * rm + 2];
  const float nx = newr[3 * rm], ny = newr[3 * rm + 1], nz = newr[3 * rm + 2];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // e_new, w_new, e_old, w_old
  for (int j = threadIdx.x; j < n; j += kThreads) {
    if (j == id) continue;
    const float px = q[3 * j], py = q[3 * j + 1], pz = q[3 * j + 2];
    pair(nx, ny, nz, px, py, pz, bx, by, bz, p, acc[0], acc[1]);
    pair(ox, oy, oz, px, py, pz, bx, by, bz, p, acc[2], acc[3]);
  }
  __shared__ float part[4][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) part[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s[4];
    for (int k = 0; k < 4; ++k) {
      s[k] = 0.f;
      for (int i = 0; i < kWarps; ++i) s[k] += part[k][i];
    }
    out[rm] = s[0] - s[2];
    out[rm_total + rm] = s[1] - s[3];
  }
}

}  // namespace

// pos (R, N, 3), box (R, 3), ids (R, M), oldr/newr (R, M, 3); out (2, R, M):
// dE then dW. Returns the launch's CUDA error code (0 on success).
extern "C" int nm_lj_delta(const float* pos, const float* box, const int* ids,
                           const float* oldr, const float* newr, float* out,
                           int R, int N, int M, float sig2, float rc2,
                           float e4, float w24, void* stream) {
  const Pot p{sig2, rc2, e4, w24};
  delta_kernel<<<R * M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, box, ids, oldr, newr, out, N, M, R * M, p);
  return static_cast<int>(cudaGetLastError());
}
