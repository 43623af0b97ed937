// P1: the LJ pair-evaluation op mix as a Hopper issue-rate probe.
//
// Replaces the Pallas probe kernels of scripts/vpu_probe.py (make_kernel,
// one per variant). Each variant runs kReps = 64 passes over a (2048, 128)
// block, one element per thread (two, packed, in the bf16 variants), and
// accumulates in registers: per pass, fresh "candidate minus mover"
// differences d0 = a - b s (s = 1 + 1e-6 i, so no pass equals another),
// d1 = a 0.5 - b, d2 = a - 0.5 b, r2, then the variant's epilogue:
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
// The TPU kernel reads its operands from VMEM in every pass; here each
// thread stages its a and b in shared memory and reads them back with a
// volatile load in every pass. Only such a load keeps the pass-invariant
// part of the mix (d1, d2, and in bf16, where the scale rounds to 1, all
// of r2) inside the loop: ptxas sees through an empty asm statement and
// hoists that part. sig2 and rc2 arrive as arguments so no multiply by 1 is
// folded. Built, like every kernel of the port, with -fmad=false: no
// multiply-add is contracted, so the probe measures the op mix as the
// port's kernels compile it, not the card's FMA peak.
//
// What bounds it: issue rate by construction (2 x 1 MB in, 1 MB out
// against 17 M pair evaluations of 12-36 operations, plus two shared
// loads per pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kReps = 64;
constexpr int kThreads = 256;

enum Variant {
  kDiv, kRecip, kRecip0, kRsqrt, kNodiv, kFmaPeak, kPairDiv, kPairIncr,
  kPairRecip, kFmaPeakBf16, kPairDivBf16, kNumVariants
};

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
probe_f32(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, int n, float sig2, float rc2) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  // each thread reads back only its own slots: no barrier
  __shared__ float sa[kThreads], sb[kThreads];
  sa[threadIdx.x] = a[t];
  sb[threadIdx.x] = b[t];
  const volatile float* va = sa;
  const volatile float* vb = sb;
  float acc = 0.0f;
  for (int i = 0; i < kReps; ++i) {
    const float av = va[threadIdx.x], bv = vb[threadIdx.x];
    const float scale = 1.0f + 1e-6f * static_cast<float>(i);
    const float d0 = av - bv * scale;
    const float d1 = av * 0.5f - bv;
    const float d2 = av - 0.5f * bv;
    const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
    if (V == kFmaPeak) {
      acc = acc + r2;
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
      acc = acc + (en - eo);
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
      acc = acc + (r2 < rc2 ? sr6 * sr6 - sr6 : 0.0f);
    }
  }
  out[t] = acc;
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
__global__ void __launch_bounds__(kThreads)
probe_bf16(const bf2* __restrict__ a, const bf2* __restrict__ b,
           float* __restrict__ out, int n2, float sig2f, float rc2f) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n2) return;
  // as in probe_f32, held as the bf16 pairs' 32-bit patterns
  __shared__ unsigned sa[kThreads], sb[kThreads];
  sa[threadIdx.x] = *reinterpret_cast<const unsigned*>(&a[t]);
  sb[threadIdx.x] = *reinterpret_cast<const unsigned*>(&b[t]);
  const volatile unsigned* va = sa;
  const volatile unsigned* vb = sb;
  const bf2 sig2 = __float2bfloat162_rn(sig2f);
  const bf2 rc2 = __float2bfloat162_rn(rc2f);
  const bf2 half = __float2bfloat162_rn(0.5f);
  bf2 acc = __float2bfloat162_rn(0.0f);
  for (int i = 0; i < kReps; ++i) {
    const unsigned ua = va[threadIdx.x], ub = vb[threadIdx.x];
    const bf2 av = *reinterpret_cast<const bf2*>(&ua);
    const bf2 bv = *reinterpret_cast<const bf2*>(&ub);
    // the i-dependent factor in f32, cast once (as the TPU kernel does)
    const bf2 scale =
        __float2bfloat162_rn(1.0f + 1e-6f * static_cast<float>(i));
    const bf2 d0 = __hsub2(av, __hmul2(bv, scale));
    const bf2 d1 = __hsub2(__hmul2(av, half), bv);
    const bf2 d2 = __hsub2(av, __hmul2(half, bv));
    const bf2 r2 = __hadd2(__hadd2(__hmul2(d0, d0), __hmul2(d1, d1)),
                           __hmul2(d2, d2));
    if (V == kFmaPeakBf16) {
      acc = __hadd2(acc, r2);
    } else {  // kPairDivBf16
      const bf2 dd = __hmul2(__float2bfloat162_rn(0.01f), bv);
      const bf2 e0 = __hsub2(d0, dd), e1 = __hsub2(d1, dd),
                e2 = __hsub2(d2, dd);
      const bf2 r2n = __hadd2(__hadd2(__hmul2(e0, e0), __hmul2(e1, e1)),
                              __hmul2(e2, e2));
      const bf2 q = __h2div(sig2, __hmul2(r2n, r2));
      const bf2 s2n = __hmul2(q, r2), s2o = __hmul2(q, r2n);
      const bf2 s6n = __hmul2(__hmul2(s2n, s2n), s2n);
      const bf2 s6o = __hmul2(__hmul2(s2o, s2o), s2o);
      const bf2 en = where_lt(r2n, rc2, __hsub2(__hmul2(s6n, s6n), s6n));
      const bf2 eo = where_lt(r2, rc2, __hsub2(__hmul2(s6o, s6o), s6o));
      acc = __hadd2(acc, __hsub2(en, eo));
    }
  }
  out[2 * t] = __low2float(acc);
  out[2 * t + 1] = __high2float(acc);
}

template <int V>
cudaError_t launch_f32(const void* a, const void* b, float* out, int n,
                       float sig2, float rc2, cudaStream_t s) {
  probe_f32<V><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), out, n,
      sig2, rc2);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_bf16(const void* a, const void* b, float* out, int n,
                        float sig2, float rc2, cudaStream_t s) {
  const int n2 = n / 2;
  probe_bf16<V><<<(n2 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const bf2*>(a), static_cast<const bf2*>(b), out, n2, sig2,
      rc2);
  return cudaGetLastError();
}

}  // namespace

// variant: the index in neuralmelting_tpu_torch/probe.py VARIANTS; a, b:
// n f32 values, or n bf16 values (n even) for the bf16 variants; out: n
// f32. Returns the launch's CUDA error code (0 on success).
extern "C" int nm_vpu_probe(int variant, const void* a, const void* b,
                            float* out, int n, float sig2, float rc2,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (variant) {
    case kDiv: e = launch_f32<kDiv>(a, b, out, n, sig2, rc2, s); break;
    case kRecip: e = launch_f32<kRecip>(a, b, out, n, sig2, rc2, s); break;
    case kRecip0: e = launch_f32<kRecip0>(a, b, out, n, sig2, rc2, s); break;
    case kRsqrt: e = launch_f32<kRsqrt>(a, b, out, n, sig2, rc2, s); break;
    case kNodiv: e = launch_f32<kNodiv>(a, b, out, n, sig2, rc2, s); break;
    case kFmaPeak:
      e = launch_f32<kFmaPeak>(a, b, out, n, sig2, rc2, s);
      break;
    case kPairDiv:
      e = launch_f32<kPairDiv>(a, b, out, n, sig2, rc2, s);
      break;
    case kPairIncr:
      e = launch_f32<kPairIncr>(a, b, out, n, sig2, rc2, s);
      break;
    case kPairRecip:
      e = launch_f32<kPairRecip>(a, b, out, n, sig2, rc2, s);
      break;
    case kFmaPeakBf16:
      e = launch_bf16<kFmaPeakBf16>(a, b, out, n, sig2, rc2, s);
      break;
    case kPairDivBf16:
      e = launch_bf16<kPairDivBf16>(a, b, out, n, sig2, rc2, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
