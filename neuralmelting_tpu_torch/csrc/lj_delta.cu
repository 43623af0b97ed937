// B5: brute-force minimum-image LJ energy and virial changes of trial
// moves, as a batch of movers and as a run of Metropolis attempts.
//
// Replaces the JAX package's Pallas kernel delta_moves_pallas
// (neuralmelting_tpu/ops/pallas/lj_kernel.py). For a mover with old and
// new position against the N atoms of its configuration, with d = mover -
// atom under the minimum image (rintf: half to even, as jnp.round) and
// r2 = dx dx + dy dy + dz dz,
//   dE = sum_{j != id, r2 < rc2} e(new) - sum e(old)
//   dW = the same sums of the pair virial w = r f
// with sr2 = sigma^2 / max(r2, 1e-4), sr6 = sr2 sr2 sr2, sr12 = sr6 sr6,
// e = 4 eps (sr12 - sr6), w = 24 eps (2 sr12 - sr6): LJCut.pair_e_w's
// operations in its order. Built with -fmad=false and IEEE division, so
// each pair term has the plain version's bits. The minimum image takes
// rint of the quotient formed as d (1/b), one multiply, and the IEEE
// divide only where that quotient lies within 1e-5 of a half-integer
// (rint's boundaries) or beyond 32 in magnitude: elsewhere both quotients
// round to one integer (|d (1/b) - d / b| <= 2^-22 |d / b|), so the image
// keeps its bits at a third of the divides' cost.
//
// One summation order for every sum of both kernels (accumulate,
// warp_sums, ordered_sum): 256 virtual threads, virtual thread v summing
// atoms j = v, v + 256, ... in index order; a butterfly over each virtual
// warp (v / 32); the eight warp sums added in order. A group of G threads
// holds virtual thread v = g + G s in its slot s: the run kernel's CTA
// (G = 256) one each, a mover's two warps in the batched kernel (G = 64)
// four. So a mover's dE and dW have the same bits in both kernels,
// whatever the launch shape.
//
// delta_run_kernel, the serial engine's path: one CTA holds one chain and
// takes a run of A consecutive position attempts in order, the chain's
// positions staged once in shared memory (SoA, 12 N bytes). An attempt
// sums its mover's terms, reduces, and thread 0 decides as
// sampler/moves.py::position does (weight = nbeta dE, accept iff ln u <
// weight, wrap the accepted position into the box, pe += acc ? dE : 0);
// an accepted position goes to shared memory and to pos before the next
// attempt. So a run is, bit for bit, A launches of delta_kernel followed
// by torch's elementwise ops, in one launch instead of ~20 small device
// operations an attempt. What bounds it: latency. An attempt at N = 256
// is one atom a thread (~60 dependent f32 instructions), a 5-level
// butterfly on 4 sums, thread 0's decision and two barriers; the next
// attempt's mover and draws are loaded during this one.
//
// delta_kernel, the batched entry point (R replicas x M movers): one CTA
// per replica and group of 8 movers, two warps a mover; the replica's
// positions staged once into shared SoA with coalesced loads (one read of
// 12 N bytes a CTA from L2, not one a mover). What bounds it: operations
// (~30 instructions an atom and side against 21 counted), at 2 x 8 warps
// a CTA and two CTAs an SM at R=64, M=32.
#include <cuda_runtime.h>

namespace {

constexpr int kVirtual = 256;          // virtual threads of a sum
constexpr int kRunThreads = kVirtual;  // the run kernel's CTA
constexpr int kWarps = kVirtual / 32;  // virtual warps
constexpr int kBatchG = 64;            // delta_kernel: threads a mover
constexpr int kBatchMovers = 8;        // delta_kernel: movers a CTA

struct Pot {
  float sig2, rc2, e4, w24;
};

// The box edges and their reciprocals.
struct Box {
  float x, y, z, ix, iy, iz;
};

__device__ __forceinline__ Box make_box(const float* b) {
  return Box{b[0], b[1], b[2], 1.0f / b[0], 1.0f / b[1], 1.0f / b[2]};
}

// d - b rintf(d / b), d / b the IEEE quotient (see the head of the file)
__device__ __forceinline__ float image(float d, float b, float ib) {
  const float q = d * ib;
  float k = rintf(q);
  if (!(fabsf(q - k) <= 0.5f - 1e-5f && fabsf(q) < 32.0f)) k = rintf(d / b);
  return d - b * k;
}

__device__ __forceinline__ void pair(float mx, float my, float mz, float px,
                                     float py, float pz, const Box& b,
                                     bool live, const Pot& p, float& e,
                                     float& w) {
  const float dx = image(mx - px, b.x, b.ix);
  const float dy = image(my - py, b.y, b.iy);
  const float dz = image(mz - pz, b.z, b.iz);
  const float r2 = dx * dx + dy * dy + dz * dz;
  if (live && r2 < p.rc2) {
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

struct Mover {
  int id;
  float nx, ny, nz, ox, oy, oz;
};

// Thread g of a group of G: its slots' sums (e_new, w_new, e_old, w_old)
// of the mover's terms against the staged atoms sx, sy, sz.
template <int G>
__device__ __forceinline__ void accumulate(const float* sx, const float* sy,
                                           const float* sz, int n,
                                           const Mover& m, const Box& b,
                                           const Pot& p, int g,
                                           float (&acc)[kVirtual / G][4]) {
#pragma unroll
  for (int s = 0; s < kVirtual / G; ++s)
    acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.0f;
  for (int base = 0; base < n; base += kVirtual) {
#pragma unroll
    for (int s = 0; s < kVirtual / G; ++s) {
      const int j = base + g + G * s;
      const bool live = j < n && j != m.id;
      const int jj = j < n ? j : 0;
      const float px = sx[jj], py = sy[jj], pz = sz[jj];
      pair(m.nx, m.ny, m.nz, px, py, pz, b, live, p, acc[s][0], acc[s][1]);
      pair(m.ox, m.oy, m.oz, px, py, pz, b, live, p, acc[s][2], acc[s][3]);
    }
  }
}

// Thread g's slots reduced by its warp's butterfly into part[q][virtual
// warp] (shared; one mover's). All G threads call it; a barrier follows.
template <int G>
__device__ __forceinline__ void warp_sums(
    const float (&acc)[kVirtual / G][4], float (*part)[kWarps], int g) {
#pragma unroll
  for (int s = 0; s < kVirtual / G; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = warp_sum(acc[s][q]);
      if ((g & 31) == 0) part[q][(g + G * s) >> 5] = v;
    }
  }
}

// The eight virtual-warp sums of one quantity, added in order.
__device__ __forceinline__ float ordered_sum(const float* w) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += w[i];
  return s;
}

// q (N, 3) AoS in device memory -> sx, sy, sz in shared memory, each
// thread of the CTA loading consecutive floats.
__device__ __forceinline__ void stage(const float* __restrict__ q, int n,
                                      float* sp) {
  for (int e = threadIdx.x; e < 3 * n; e += blockDim.x) {
    const int j = e / 3;
    sp[(e - 3 * j) * n + j] = q[e];
  }
}

__global__ void __launch_bounds__(kBatchG * kBatchMovers)
delta_kernel(const float* __restrict__ pos, const float* __restrict__ box,
             const int* __restrict__ ids, const float* __restrict__ oldr,
             const float* __restrict__ newr, float* __restrict__ out, int n,
             int m, int rm_total, Pot p) {
  extern __shared__ float sp[];
  __shared__ float part[kBatchMovers][4][kWarps];
  const int r = blockIdx.y;
  stage(pos + static_cast<size_t>(r) * n * 3, n, sp);
  __syncthreads();
  const int local = threadIdx.x / kBatchG, g = threadIdx.x % kBatchG;
  const int mv = blockIdx.x * kBatchMovers + local;
  const int rm = r * m + mv;
  if (mv < m) {  // whole warps
    const Mover mo{ids[rm],          newr[3 * rm],     newr[3 * rm + 1],
                   newr[3 * rm + 2], oldr[3 * rm],     oldr[3 * rm + 1],
                   oldr[3 * rm + 2]};
    float acc[kVirtual / kBatchG][4];
    accumulate<kBatchG>(sp, sp + n, sp + 2 * n, n, mo, make_box(box + 3 * r),
                        p, g, acc);
    warp_sums<kBatchG>(acc, part[local], g);
  }
  __syncthreads();
  if (mv < m && g == 0) {
    out[rm] = ordered_sum(part[local][0]) - ordered_sum(part[local][2]);
    out[rm_total + rm] =
        ordered_sum(part[local][1]) - ordered_sum(part[local][3]);
  }
}

__global__ void __launch_bounds__(kRunThreads)
delta_run_kernel(float* __restrict__ pos, const float* __restrict__ box,
                 const int* __restrict__ ids, const float* __restrict__ disp,
                 const float* __restrict__ lnu,
                 const float* __restrict__ nbeta, float* __restrict__ pe,
                 float* __restrict__ vir, bool* __restrict__ acc_out,
                 float* __restrict__ weight, int n, int a, Pot p) {
  extern __shared__ float sp[];
  float* sx = sp;
  float* sy = sp + n;
  float* sz = sp + 2 * n;
  __shared__ float part[4][kWarps];
  stage(pos, n, sp);
  const Box b = make_box(box);
  float e_run = 0.0f, w_run = 0.0f, nb = 0.0f;  // thread 0's
  if (threadIdx.x == 0) {
    e_run = *pe;
    w_run = *vir;
    nb = *nbeta;
  }
  // attempt k's mover and draws, loaded during attempt k - 1
  int id = a > 0 ? ids[0] : 0;
  float ddx = 0.0f, ddy = 0.0f, ddz = 0.0f, lu = 0.0f;
  if (a > 0) {
    ddx = disp[0];
    ddy = disp[1];
    ddz = disp[2];
    lu = lnu[0];
  }
  __syncthreads();
  for (int k = 0; k < a; ++k) {
    Mover mo;
    mo.id = id;
    mo.ox = sx[id];
    mo.oy = sy[id];
    mo.oz = sz[id];
    mo.nx = mo.ox + ddx;
    mo.ny = mo.oy + ddy;
    mo.nz = mo.oz + ddz;
    const float lnu_k = lu;
    if (k + 1 < a) {
      id = ids[k + 1];
      ddx = disp[3 * k + 3];
      ddy = disp[3 * k + 4];
      ddz = disp[3 * k + 5];
      lu = lnu[k + 1];
    }
    float acc[1][4];
    accumulate<kRunThreads>(sx, sy, sz, n, mo, b, p, threadIdx.x, acc);
    warp_sums<kRunThreads>(acc, part, threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0) {
      const float de = ordered_sum(part[0]) - ordered_sum(part[2]);
      const float dw = ordered_sum(part[1]) - ordered_sum(part[3]);
      const float wgt = nb * de;
      const bool ok = lnu_k < wgt;
      weight[k] = wgt;
      acc_out[k] = ok;
      if (ok) {
        const float wx = mo.nx - b.x * floorf(mo.nx / b.x);
        const float wy = mo.ny - b.y * floorf(mo.ny / b.y);
        const float wz = mo.nz - b.z * floorf(mo.nz / b.z);
        sx[mo.id] = wx;
        sy[mo.id] = wy;
        sz[mo.id] = wz;
        pos[3 * mo.id] = wx;
        pos[3 * mo.id + 1] = wy;
        pos[3 * mo.id + 2] = wz;
      }
      e_run = e_run + (ok ? de : 0.0f);
      w_run = w_run + (ok ? dw : 0.0f);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *pe = e_run;
    *vir = w_run;
  }
}

}  // namespace

// dynamic shared memory bytes of either kernel for N atoms
extern "C" int nm_lj_delta_smem(int N) { return 12 * N; }

// the larger static shared memory of the two kernels (the run's reduction)
extern "C" int nm_lj_delta_static_smem() {
  cudaFuncAttributes a{}, b{};
  cudaFuncGetAttributes(&a, delta_kernel);
  cudaFuncGetAttributes(&b, delta_run_kernel);
  return static_cast<int>(a.sharedSizeBytes > b.sharedSizeBytes
                              ? a.sharedSizeBytes
                              : b.sharedSizeBytes);
}

// pos (R, N, 3), box (R, 3), ids (R, M), oldr/newr (R, M, 3); out (2, R, M):
// dE then dW. Returns the launch's CUDA error code (0 on success).
extern "C" int nm_lj_delta(const float* pos, const float* box, const int* ids,
                           const float* oldr, const float* newr, float* out,
                           int R, int N, int M, float sig2, float rc2,
                           float e4, float w24, void* stream) {
  const Pot p{sig2, rc2, e4, w24};
  const int smem = nm_lj_delta_smem(N);
  cudaError_t e = cudaFuncSetAttribute(
      delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kBatchMovers - 1) / kBatchMovers, R);
  delta_kernel<<<grid, kBatchG * kBatchMovers, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      pos, box, ids, oldr, newr, out, N, M, R * M, p);
  return static_cast<int>(cudaGetLastError());
}

// One chain: pos (N, 3) and box (3,); a run of A position attempts: ids
// (A,), disp (A, 3), lnu (A,); nbeta, pe, vir 0-dim. Updates pos, pe and
// vir in place; writes acc (A,) and weight (A,). Returns the launch's CUDA
// error code (0 on success).
extern "C" int nm_lj_delta_run(float* pos, const float* box, const int* ids,
                               const float* disp, const float* lnu,
                               const float* nbeta, float* pe, float* vir,
                               bool* acc, float* weight, int N, int A,
                               float sig2, float rc2, float e4, float w24,
                               void* stream) {
  const Pot p{sig2, rc2, e4, w24};
  const int smem = nm_lj_delta_smem(N);
  cudaError_t e = cudaFuncSetAttribute(
      delta_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  delta_run_kernel<<<1, kRunThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      pos, box, ids, disp, lnu, nbeta, pe, vir, acc, weight, N, A, p);
  return static_cast<int>(cudaGetLastError());
}
