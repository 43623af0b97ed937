"""Kernel P1: the LJ pair-evaluation op mix as an issue-rate probe.

    python -m neuralmelting_tpu_torch.probe        # on the card

Counterpart of ``scripts/vpu_probe.py`` (the Pallas probe kernels of
``make_kernel``). Each variant of ``VARIANTS`` runs REPS = 64 passes of
the LJ pair op mix over two (2048, 128) blocks and accumulates (the
variants are described in ``csrc/vpu_probe.cu``). ``probe`` launches the
CUDA kernel; ``probe_plain`` is its plain PyTorch version, with an exact
reciprocal or reciprocal square root where the kernel approximates, for
CPU tensors, the tests and ``chip_smoke.py``. ``LAUNCHES["probe"]``
counts kernel launches only.

``measure`` times every variant over enough launches for at least 10 ms
(CUDA events; torch.profiler for each launch's device time, since a
launch takes less time on the card than the host needs to issue it) and
reports ns per pair evaluation, the f32 operations per
pair counted from the code (``OPS``: adds, multiplies, divides and
approximate reciprocals or square roots, one each; compares, selects and
the kernels' two shared-memory operand loads a pass not counted), and
the share of the card's 67 TFLOP/s f32 peak (NVIDIA's H100 SXM data
sheet, no tensor cores) that this reaches. The kernels are built with
-fmad=false, as every kernel of the port: the probe measures the op mix
as the port's kernels compile it, with no contracted multiply-add, so a
share near 50% would be the f32 issue ceiling of such code (a bf16x2
instruction does two pairs' operation, so 100% for the bf16 variants).
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS, LANES, REPS = 2048, 128, 64
VARIANTS = ("div", "recip", "recip0", "rsqrt", "nodiv", "fma_peak",
            "pair_div", "pair_incr", "pair_recip", "fma_peak_bf16",
            "pair_div_bf16")
# f32 operations per pair evaluation, counted from csrc/vpu_probe.cu: 11
# for d0, d1, d2 and r2, then the epilogue and the accumulate
OPS = {"div": 17, "recip": 21, "recip0": 18, "rsqrt": 19, "nodiv": 18,
       "fma_peak": 12, "pair_div": 34, "pair_incr": 36, "pair_recip": 35,
       "fma_peak_bf16": 12, "pair_div_bf16": 34}
F32_PEAK = 67e12
SIG2, RC2 = 1.0, 6.25
LAUNCHES = {"probe": 0}


def reset_launches():
    LAUNCHES["probe"] = 0


def dtype_of(variant):
    return torch.bfloat16 if variant.endswith("_bf16") else torch.float32


def inputs(device, seed=0):
    """The probe's (2048, 128) blocks, uniform in [1, 2), as
    scripts/vpu_probe.py makes them (numpy RandomState seeds 0 and 1)."""
    a, b = (np.random.RandomState(seed + k).uniform(
        1.0, 2.0, (ROWS, LANES)).astype(np.float32) for k in (0, 1))
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def probe(variant, a, b):
    """One launch of P1's ``variant`` on CUDA tensors: (ROWS, LANES) f32."""
    from neuralmelting_tpu_torch.ops import _build
    if a.device.type != "cuda":
        raise ValueError("the probe kernel runs on CUDA tensors")
    dt = dtype_of(variant)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != dt or t.shape != (ROWS, LANES) or \
                not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name}: expected contiguous {dt} "
                             f"({ROWS}, {LANES}) on {a.device}")
    out = torch.empty((ROWS, LANES), dtype=torch.float32, device=a.device)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.nm_vpu_probe(VARIANTS.index(variant), a.data_ptr(),
                               b.data_ptr(), out.data_ptr(), a.numel(),
                               SIG2, RC2,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"P1 {variant} launch failed: CUDA error {err}")
    LAUNCHES["probe"] += 1
    return out


def probe_plain(variant, a, b):
    """The plain PyTorch version of ``variant``: the same operations in
    the same order and type, with exact reciprocals and square roots."""
    dt = dtype_of(variant)
    a, b = a.to(dt), b.to(dt)

    def c(v):
        # a constant rounded to the working type, as the kernels take it
        return float(torch.tensor(v, dtype=torch.float32).to(dt))

    sig2 = a.new_full((), SIG2)     # a tensor: float / tensor is no divide
    acc = torch.zeros_like(a)
    for i in range(REPS):
        scale = c(np.float32(1.0) + np.float32(1e-6) * np.float32(i))
        d0 = a - b * scale
        d1 = a * c(0.5) - b
        d2 = a - c(0.5) * b
        r2 = d0 * d0 + d1 * d1 + d2 * d2
        if variant.startswith("fma_peak"):
            acc = acc + r2
            continue
        if variant.startswith("pair_"):
            dd = c(0.01) * b
            if variant == "pair_incr":
                dot = d0 * dd + d1 * dd + d2 * dd
                r2n = r2 - (dot + dot) + c(3.0) * (dd * dd)
            else:
                e0, e1, e2 = d0 - dd, d1 - dd, d2 - dd
                r2n = e0 * e0 + e1 * e1 + e2 * e2
            if variant == "pair_recip":
                q = sig2 * torch.reciprocal(r2n * r2)
            else:
                q = sig2 / (r2n * r2)
            s2n, s2o = q * r2, q * r2n
            s6n, s6o = s2n * s2n * s2n, s2o * s2o * s2o
            en = torch.where(r2n < RC2, s6n * s6n - s6n, 0.0)
            eo = torch.where(r2 < RC2, s6o * s6o - s6o, 0.0)
            acc = acc + (en - eo)
            continue
        if variant == "div":
            sr2 = sig2 / r2
        elif variant == "recip":
            y = torch.reciprocal(r2)
            y = y * (2.0 - r2 * y)
            sr2 = sig2 * y
        elif variant == "recip0":
            sr2 = sig2 * torch.reciprocal(r2)
        elif variant == "rsqrt":
            y = torch.rsqrt(r2)
            sr2 = sig2 * y * y
        elif variant == "nodiv":
            sr2 = sig2 * (2.0 - r2)
        else:
            raise ValueError(variant)
        sr6 = sr2 * sr2 * sr2
        acc = acc + torch.where(r2 < RC2, sr6 * sr6 - sr6, 0.0)
    return acc.to(torch.float32)


def time_ms(fn, min_ms=10.0):
    """(ms per call, calls): CUDA events over enough calls for min_ms of
    the stream's time. A call that takes less device time than the host
    needs to issue it measures the host."""
    fn()
    torch.cuda.synchronize()
    n = 8
    while True:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        total = t0.elapsed_time(t1)
        if total >= min_ms:
            return total / n, n
        n = max(2 * n, int(math.ceil(n * 1.2 * min_ms / max(total, 1e-3))))


def device_ms(fn, calls, match):
    """Mean device time (ms) of the kernels whose name contains ``match``
    over ``calls`` calls of ``fn``, from torch.profiler: the kernel's own
    time, without the host's time to issue it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if match in ev.key and ev.device_type == \
                torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            total += ev.self_cuda_time_total if t is None else t
            count += ev.count
    if count == 0 or total <= 0:
        raise RuntimeError(f"the profiler saw no device time of {match!r}")
    return total / count / 1e3


def measure(device="cuda"):
    """Per variant: dict(ms, launches, ns_per_pair, ops_per_pair,
    share_f32_peak, event_ms): ``ms`` is the kernel's device time per
    launch (torch.profiler over the timed launches' count), ``event_ms``
    the CUDA-event time per launch as issued back to back (at least
    10 ms in all; below ~20 us per launch that is the host's issue
    time). Launches are counted in ``LAUNCHES``."""
    a, b = inputs(device)
    pairs = ROWS * LANES * REPS
    out = {}
    for v in VARIANTS:
        dt = dtype_of(v)
        av, bv = a.to(dt), b.to(dt)
        event_ms, n = time_ms(lambda: probe(v, av, bv))
        ms = device_ms(lambda: probe(v, av, bv), n, "probe_")
        out[v] = dict(ms=ms, launches=n, ns_per_pair=ms * 1e6 / pairs,
                      ops_per_pair=OPS[v],
                      share_f32_peak=OPS[v] * pairs / (ms * 1e-3) / F32_PEAK,
                      event_ms=event_ms)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the probe runs on the card: no CUDA device")
    for v, r in measure().items():
        print(f"{v:14s} {r['ms']:8.4f} ms/launch on the device "
              f"({r['event_ms']:.4f} as issued, {r['launches']} launches) "
              f"{r['ns_per_pair']:8.5f} ns/pair  {r['ops_per_pair']:3d} "
              f"f32 ops/pair  {100 * r['share_f32_peak']:6.2f}% of 67 TFLOP/s")


if __name__ == "__main__":
    main()
