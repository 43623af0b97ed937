// P1: the LJ pair-evaluation op mix as a Hopper issue-rate probe.
//
// Replaces the Pallas probe kernels of scripts/vpu_probe.py (make_kernel,
// one per variant). Each variant runs `reps` passes (the script's REPS =
// 64 by default) over a (2048, 128) block, one element per thread at a
// time (two, packed, in the bf16 variants), and accumulates in registers:
// per pass i, fresh "candidate minus mover" differences d0 = a - b s_i
// (s_i = 1 + 1e-6 i, so no pass equals another), d1 = a 0.5 - b,
// d2 = a - 0.5 b, r2, then the variant's epilogue:
//   div        sig2 / r2 (what the port's kernels ship), then sr6, e
//   recip      rcp.approx.ftz.f32 + one Newton step
//   recip0     rcp.approx.ftz.f32 alone
//   rsqrt      rsqrtf(r2)^2
//   nodiv      sig2 (2 - r2) (a cost model, not a valid e)
//   fma_peak   acc + r2 alone
//   pair_div   old and displaced mover, e(new) - e(old), one shared divide
//   pair_incr  the same with r2(new) from r2(old) incrementally
//   pair_recip pair_div with rcp.approx.ftz.f32 for the divide
//   *_bf16     fma_peak and pair_div on packed __nv_bfloat162 operands
//
// A persistent launch: as many CTAs as fit on the card at once, each
// walking its share of the block, so that a launch of >= 1 ms (a large
// `reps`) measures the op mix and not a launch's ramp.
//
// The overhead a pass beside the mix, each instruction an issue slot:
// - The TPU kernel reads its operands from VMEM in every pass; here each
//   thread stages its (a, b) in shared memory and reads both back with one
//   volatile 64-bit load a pass. Only such a load keeps the pass-invariant
//   part of the mix (d1, d2, dd) inside the loop: ptxas sees through an
//   empty asm statement and hoists that part.
// - s_i comes from a table (the wrapper's, in the working type), four
//   passes a 16-byte load, where the TPU kernel computes it on its scalar
//   unit; computed here it would take three instructions a pass.
// - The pass loop runs kUnroll passes an iteration.
// sig2 and rc2 arrive as arguments so no multiply by 1 is folded. Built,
// like every kernel of the port, with -fmad=false: no multiply-add is
// contracted, so the probe measures the op mix as the port's kernels
// compile it (one operation an FP32 instruction: its ceiling is 50% of
// the card's FMA peak), not the card's FMA peak.
//
// What bounds it: issue rate by construction (2 x 1 MB in, 1 MB out
// against 262144 x reps pair evaluations of 12-36 operations).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // passes an iteration; reps is a multiple

enum Variant {
  kDiv, kRecip, kRecip0, kRsqrt, kNodiv, kFmaPeak, kPairDiv, kPairIncr,
  kPairRecip, kFmaPeakBf16, kPairDivBf16, kNumVariants
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one pass's term, added to the accumulator
template <int V>
__device__ __forceinline__ float term_f32(float av, float bv, float scale,
                                          float sig2, float rc2) {
  const float d0 = av - bv * scale;
  const float d1 = av * 0.5f - bv;
  const float d2 = av - 0.5f * bv;
  const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
  if (V == kFmaPeak) {
    return r2;
  } else if (V == kPairDiv || V == kPairIncr || V == kPairRecip) {
    const float dd = 0.01f * bv;
    float r2n;
    if (V == kPairIncr) {
      const float dot = d0 * dd + d1 * dd + d2 * dd;
      r2n = r2 - (dot + dot) + 3.0f * (dd * dd);
    } else {
      const float e0 = d0 - dd, e1 = d1 - dd, e2 = d2 - dd;
      r2n = e0 * e0 + e1 * e1 + e2 * e2;
    }
    const float q = V == kPairRecip ? sig2 * rcp_approx(r2n * r2)
                                    : sig2 / (r2n * r2);
    const float s2n = q * r2, s2o = q * r2n;
    const float s6n = s2n * s2n * s2n, s6o = s2o * s2o * s2o;
    const float en = r2n < rc2 ? s6n * s6n - s6n : 0.0f;
    const float eo = r2 < rc2 ? s6o * s6o - s6o : 0.0f;
    return en - eo;
  } else {
    float sr2;
    if (V == kDiv) {
      sr2 = sig2 / r2;
    } else if (V == kRecip) {
      float y = rcp_approx(r2);
      y = y * (2.0f - r2 * y);
      sr2 = sig2 * y;
    } else if (V == kRecip0) {
      sr2 = sig2 * rcp_approx(r2);
    } else if (V == kRsqrt) {
      const float y = rsqrtf(r2);
      sr2 = sig2 * y * y;
    } else {  // kNodiv
      sr2 = sig2 * (2.0f - r2);
    }
    const float sr6 = sr2 * sr2 * sr2;
    return r2 < rc2 ? sr6 * sr6 - sr6 : 0.0f;
  }
}

__device__ __forceinline__ unsigned long long pack(unsigned lo,
                                                   unsigned hi) {
  return static_cast<unsigned long long>(hi) << 32 | lo;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_f32(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ scales, float* __restrict__ out, int n,
          int reps, float sig2, float rc2) {
  // each thread reads back only its own slot: no barrier
  __shared__ unsigned long long sab[kThreads];
  volatile unsigned long long* vab = sab;
  const float4* sc4 = reinterpret_cast<const float4*>(scales);
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < n;
       t += gridDim.x * kThreads) {
    vab[threadIdx.x] = pack(__float_as_uint(a[t]), __float_as_uint(b[t]));
    float acc = 0.0f;
#pragma unroll 1
    for (int i = 0; i < reps; i += kUnroll) {
      float sc[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll / 4; ++q) {
        const float4 s = __ldg(sc4 + i / 4 + q);
        sc[4 * q] = s.x;
        sc[4 * q + 1] = s.y;
        sc[4 * q + 2] = s.z;
        sc[4 * q + 3] = s.w;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned long long ab = vab[threadIdx.x];
        const float av = __uint_as_float(static_cast<unsigned>(ab));
        const float bv = __uint_as_float(static_cast<unsigned>(ab >> 32));
        acc = acc + term_f32<V>(av, bv, sc[u], sig2, rc2);
      }
    }
    out[t] = acc;
  }
}

using bf2 = __nv_bfloat162;

__device__ __forceinline__ bf2 where_lt(bf2 x, bf2 lim, bf2 v) {
  const __nv_bfloat16 z = __float2bfloat16(0.0f);
  const __nv_bfloat16 lo =
      __hlt(__low2bfloat16(x), __low2bfloat16(lim)) ? __low2bfloat16(v) : z;
  const __nv_bfloat16 hi =
      __hlt(__high2bfloat16(x), __high2bfloat16(lim)) ? __high2bfloat16(v)
                                                       : z;
  return __halves2bfloat162(lo, hi);
}

template <int V>
__device__ __forceinline__ bf2 term_bf16(bf2 av, bf2 bv, bf2 scale, bf2 sig2,
                                         bf2 rc2, bf2 half) {
  const bf2 d0 = __hsub2(av, __hmul2(bv, scale));
  const bf2 d1 = __hsub2(__hmul2(av, half), bv);
  const bf2 d2 = __hsub2(av, __hmul2(half, bv));
  const bf2 r2 = __hadd2(__hadd2(__hmul2(d0, d0), __hmul2(d1, d1)),
                         __hmul2(d2, d2));
  if (V == kFmaPeakBf16) return r2;
  // kPairDivBf16
  const bf2 dd = __hmul2(__float2bfloat162_rn(0.01f), bv);
  const bf2 e0 = __hsub2(d0, dd), e1 = __hsub2(d1, dd), e2 = __hsub2(d2, dd);
  const bf2 r2n = __hadd2(__hadd2(__hmul2(e0, e0), __hmul2(e1, e1)),
                          __hmul2(e2, e2));
  const bf2 q = __h2div(sig2, __hmul2(r2n, r2));
  const bf2 s2n = __hmul2(q, r2), s2o = __hmul2(q, r2n);
  const bf2 s6n = __hmul2(__hmul2(s2n, s2n), s2n);
  const bf2 s6o = __hmul2(__hmul2(s2o, s2o), s2o);
  const bf2 en = where_lt(r2n, rc2, __hsub2(__hmul2(s6n, s6n), s6n));
  const bf2 eo = where_lt(r2, rc2, __hsub2(__hmul2(s6o, s6o), s6o));
  return __hsub2(en, eo);
}

__device__ __forceinline__ bf2 as_bf2(unsigned u) {
  return *reinterpret_cast<const bf2*>(&u);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_bf16(const bf2* __restrict__ a, const bf2* __restrict__ b,
           const unsigned* __restrict__ scales, float* __restrict__ out,
           int n2, int reps, float sig2f, float rc2f) {
  // as in probe_f32, (a, b) held as the bf16 pairs' 32-bit patterns; the
  // table holds each pass's scale, rounded once from f32 (as the TPU
  // kernel casts it), in both halves
  __shared__ unsigned long long sab[kThreads];
  volatile unsigned long long* vab = sab;
  const uint4* sc4 = reinterpret_cast<const uint4*>(scales);
  const bf2 sig2 = __float2bfloat162_rn(sig2f);
  const bf2 rc2 = __float2bfloat162_rn(rc2f);
  const bf2 half = __float2bfloat162_rn(0.5f);
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < n2;
       t += gridDim.x * kThreads) {
    vab[threadIdx.x] = pack(*reinterpret_cast<const unsigned*>(&a[t]),
                            *reinterpret_cast<const unsigned*>(&b[t]));
    bf2 acc = __float2bfloat162_rn(0.0f);
#pragma unroll 1
    for (int i = 0; i < reps; i += kUnroll) {
      unsigned sc[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll / 4; ++q) {
        const uint4 s = __ldg(sc4 + i / 4 + q);
        sc[4 * q] = s.x;
        sc[4 * q + 1] = s.y;
        sc[4 * q + 2] = s.z;
        sc[4 * q + 3] = s.w;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned long long ab = vab[threadIdx.x];
        const bf2 av = as_bf2(static_cast<unsigned>(ab));
        const bf2 bv = as_bf2(static_cast<unsigned>(ab >> 32));
        acc = __hadd2(acc, term_bf16<V>(av, bv, as_bf2(sc[u]), sig2, rc2,
                                        half));
      }
    }
    out[2 * t] = __low2float(acc);
    out[2 * t + 1] = __high2float(acc);
  }
}

// CTAs of a persistent launch of `kernel` over `work` threads' worth of
// elements: every CTA that fits on the card at once, no more than the work
// needs
template <typename K>
int persistent_grid(K kernel, int work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  const int need = (work + kThreads - 1) / kThreads;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  return need < fit ? need : fit;
}

template <int V>
cudaError_t launch_f32(const void* a, const void* b, const void* scales,
                       float* out, int n, int reps, float sig2, float rc2,
                       cudaStream_t s) {
  probe_f32<V><<<persistent_grid(probe_f32<V>, n), kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(scales), out, n, reps, sig2, rc2);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_bf16(const void* a, const void* b, const void* scales,
                        float* out, int n, int reps, float sig2, float rc2,
                        cudaStream_t s) {
  const int n2 = n / 2;
  probe_bf16<V><<<persistent_grid(probe_bf16<V>, n2), kThreads, 0, s>>>(
      static_cast<const bf2*>(a), static_cast<const bf2*>(b),
      static_cast<const unsigned*>(scales), out, n2, reps, sig2, rc2);
  return cudaGetLastError();
}

}  // namespace

// variant: the index in neuralmelting_tpu_torch/probe.py VARIANTS; a, b:
// n f32 values, or n bf16 values (n even) for the bf16 variants; scales:
// reps values s_i, f32, or bf16 pairs (s_i in both halves) for the bf16
// variants; out: n f32; reps a positive multiple of kUnroll. Returns the
// launch's CUDA error code (0 on success).
extern "C" int nm_vpu_probe(int variant, const void* a, const void* b,
                            const void* scales, float* out, int n, int reps,
                            float sig2, float rc2, void* stream) {
  if (reps <= 0 || reps % kUnroll != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (variant) {
#define NM_F32(V)                                                 \
  case V:                                                         \
    e = launch_f32<V>(a, b, scales, out, n, reps, sig2, rc2, s);  \
    break;
#define NM_BF16(V)                                                \
  case V:                                                         \
    e = launch_bf16<V>(a, b, scales, out, n, reps, sig2, rc2, s); \
    break;
    NM_F32(kDiv)
    NM_F32(kRecip)
    NM_F32(kRecip0)
    NM_F32(kRsqrt)
    NM_F32(kNodiv)
    NM_F32(kFmaPeak)
    NM_F32(kPairDiv)
    NM_F32(kPairIncr)
    NM_F32(kPairRecip)
    NM_BF16(kFmaPeakBf16)
    NM_BF16(kPairDivBf16)
#undef NM_F32
#undef NM_BF16
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// passes an iteration of the pass loop (reps must be a multiple of it)
extern "C" int nm_vpu_probe_unroll() { return kUnroll; }
