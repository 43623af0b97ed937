"""Kernel P1: the LJ pair-evaluation op mix as an issue-rate probe.

    python -m neuralmelting_tpu_torch.probe        # on the card

Counterpart of ``scripts/vpu_probe.py`` (the Pallas probe kernels of
``make_kernel``). Each variant of ``VARIANTS`` runs ``reps`` passes (the
script's REPS = 64 by default) of the LJ pair op mix over two (2048, 128)
blocks and accumulates (the variants are described in
``csrc/vpu_probe.cu``). ``probe`` launches the CUDA kernel, a persistent
launch; ``probe_plain`` is its plain PyTorch version, with an exact
reciprocal or reciprocal square root where the kernel approximates, for
CPU tensors, the tests and ``chip_smoke.py``. Pass i scales by s_i = 1 +
1e-6 i in f32 (``scales``), rounded once to bf16 in the bf16 variants.
``LAUNCHES["probe"]`` counts kernel launches only.

``measure`` times every variant at a ``reps`` where one launch lasts at
least 1 ms (found from a launch at REPS), so that a fixed ramp a launch
weighs at most ~2%, over at least 10 ms of launches (CUDA events; the
launch's device time from torch.profiler), and reports ns per pair
evaluation, the f32 operations per pair counted from the code (``OPS``:
adds, multiplies, divides and approximate reciprocals or square roots,
one each; compares and selects not counted) and two shares of what this
reaches: of the card's 67 TFLOP/s f32 peak (NVIDIA's H100 SXM data
sheet, no tensor cores, an FMA counted as two operations), and of the
issue ceiling of code built with -fmad=false, as every kernel of the
port is (``issue_ceiling``): one operation an FP32 instruction, 50% of
that peak (a bf16x2 instruction does two pairs' operation, so 100% for
the bf16 variants).
``main`` also samples the SM clock while it times (``sm_clocks``).
``sass_counts`` reads each variant's pass loop from ``cuobjdump -sass``
of the built library: its arithmetic instructions (FP32, or bf16x2) and
its other instructions a pass, whose sum sets the ceiling 50% x OPS /
(instructions a pass) that the variant can reach.
"""

from __future__ import annotations

import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

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
# least device time of one timed launch
MIN_LAUNCH_MS = 1.0
# SASS opcodes of one f32 or bf16x2 operation of the mix
ARITH_OPS = ("FADD", "FMUL", "FFMA", "MUFU", "HADD2", "HMUL2", "HFMA2")
_SCALES = {}


def reset_launches():
    LAUNCHES["probe"] = 0


def unroll():
    """Passes an iteration of the kernels' pass loop (csrc/vpu_probe.cu
    kUnroll): a launch's reps is a multiple of it."""
    from neuralmelting_tpu_torch.ops import _build
    return _build.load().nm_vpu_probe_unroll()


def dtype_of(variant):
    return torch.bfloat16 if variant.endswith("_bf16") else torch.float32


def inputs(device, seed=0):
    """The probe's (2048, 128) blocks, uniform in [1, 2), as
    scripts/vpu_probe.py makes them (numpy RandomState seeds 0 and 1)."""
    a, b = (np.random.RandomState(seed + k).uniform(
        1.0, 2.0, (ROWS, LANES)).astype(np.float32) for k in (0, 1))
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def scales(reps):
    """(reps,) f32 numpy: s_i = 1 + 1e-6 i, as the script computes it."""
    return np.float32(1.0) + np.float32(1e-6) * np.arange(reps,
                                                          dtype=np.float32)


def _scale_table(variant, reps, device):
    """The kernel's table of s_i: f32, or for the bf16 variants s_i
    rounded to bf16 in both halves of a 32-bit word."""
    dt = dtype_of(variant)
    key = (dt, reps, str(device))
    if key not in _SCALES:
        s = torch.as_tensor(scales(reps))
        if dt == torch.bfloat16:
            h = s.to(dt).view(torch.int16).numpy().view(np.uint16)
            s = torch.as_tensor((h.astype(np.uint32) * 0x10001)
                                .view(np.int32))
        _SCALES[key] = s.to(device)
    return _SCALES[key]


def probe(variant, a, b, reps=REPS):
    """One launch of P1's ``variant`` on CUDA tensors: (ROWS, LANES) f32;
    ``reps`` a multiple of ``unroll()``."""
    from neuralmelting_tpu_torch.ops import _build
    if a.device.type != "cuda":
        raise ValueError("the probe kernel runs on CUDA tensors")
    if reps <= 0 or reps % unroll():
        raise ValueError(f"reps {reps}: the kernel takes a positive "
                         f"multiple of {unroll()}")
    dt = dtype_of(variant)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != dt or t.shape != (ROWS, LANES) or \
                not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name}: expected contiguous {dt} "
                             f"({ROWS}, {LANES}) on {a.device}")
    out = torch.empty((ROWS, LANES), dtype=torch.float32, device=a.device)
    table = _scale_table(variant, reps, a.device)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.nm_vpu_probe(VARIANTS.index(variant), a.data_ptr(),
                               b.data_ptr(), table.data_ptr(),
                               out.data_ptr(), a.numel(), reps, SIG2, RC2,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"P1 {variant} launch failed: CUDA error {err}")
    LAUNCHES["probe"] += 1
    return out


def probe_plain(variant, a, b, reps=REPS):
    """The plain PyTorch version of ``variant``: the same operations in
    the same order and type, with exact reciprocals and square roots."""
    dt = dtype_of(variant)
    a, b = a.to(dt), b.to(dt)

    def c(v):
        # a constant rounded to the working type, as the kernels take it
        return float(torch.tensor(v, dtype=torch.float32).to(dt))

    sig2 = a.new_full((), SIG2)     # a tensor: float / tensor is no divide
    acc = torch.zeros_like(a)
    for scale in scales(reps):
        scale = c(scale)
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


def _profiled_ms(fn, calls, match):
    """(total device ms, launches) of the kernels whose name contains
    ``match`` in one torch.profiler session over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
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
    return total / 1e3, count


def _event_ms(fn, calls):
    """Mean ms of a call between two CUDA events recorded around it, calls
    issued back to back: the device time of a call that outlasts its
    issue, the issue interval of one that does not."""
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    for e0, e1 in evs:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in evs) / calls


# (match, calls) of every device_ms that no profiler session could time
EVENT_FALLBACKS = []


def device_ms(fn, calls, match, sessions=3):
    """Mean device time (ms) of the kernels whose name contains ``match``
    over ``calls`` calls of ``fn``, from torch.profiler: the kernel's own
    time, without the host's time to issue it. The mean is over the
    launches the session recorded. torch.profiler drops a record now and
    then, and many more once the process has profiled CUDA-graph
    replays (``profiler_drops``); on the card it has also recorded no
    launch at all in a session. A session that recorded fewer launches
    than calls is reported on stderr, one that recorded none is run
    again, up to ``sessions`` in all, and if none recorded any the time
    is taken with CUDA events around each call (``_event_ms``), reported
    on stderr and in ``EVENT_FALLBACKS``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        total, count = _profiled_ms(fn, calls, match)
        if count < calls:
            print(f"device_ms: the profiler recorded {count} launches of "
                  f"{match!r} in {calls} calls", file=sys.stderr, flush=True)
        if count > 0 and total > 0:
            return total / count
    ms = _event_ms(fn, calls)
    EVENT_FALLBACKS.append((match, calls))
    print(f"device_ms: no profiler session of {sessions} saw {match!r}; "
          f"{ms:.4f} ms a call from CUDA events around each of {calls} "
          f"calls", file=sys.stderr, flush=True)
    return ms


def issue_ceiling(variant):
    """The share of 67 TFLOP/s at one operation an instruction and one
    instruction a cycle: 50% in f32, 100% in bf16x2 (two pairs an
    instruction)."""
    return 1.0 if dtype_of(variant) == torch.bfloat16 else 0.5


def timing_reps(variant, a, b):
    """(reps, device ms of a launch at REPS): the multiple of unroll() at
    which a launch should last MIN_LAUNCH_MS, scaled from REPS with a
    tenth to spare."""
    ms = device_ms(lambda: probe(variant, a, b), 20, "probe_")
    per = MIN_LAUNCH_MS * 1.1 * REPS / ms
    u = unroll()
    return u * max(1, math.ceil(per / u)), ms


def measure(device="cuda"):
    """Per variant: dict(reps, ms, launches, ns_per_pair, ops_per_pair,
    share_f32_peak, share_issue, event_ms, ms_at_reps): ``ms`` is the
    kernel's device time per launch at ``reps`` (torch.profiler over the
    timed launches' count), at least MIN_LAUNCH_MS, ``event_ms`` the
    CUDA-event time per launch as issued back to back (at least 10 ms in
    all), ``ms_at_reps`` one launch's device time at REPS. Launches are
    counted in ``LAUNCHES``."""
    a, b = inputs(device)
    out = {}
    for v in VARIANTS:
        dt = dtype_of(v)
        av, bv = a.to(dt), b.to(dt)
        reps, ms64 = timing_reps(v, av, bv)
        while True:
            event_ms, n = time_ms(lambda: probe(v, av, bv, reps))
            ms = device_ms(lambda: probe(v, av, bv, reps), n, "probe_")
            if ms >= MIN_LAUNCH_MS:
                break
            reps *= 2
        pairs = ROWS * LANES * reps
        share = OPS[v] * pairs / (ms * 1e-3) / F32_PEAK
        out[v] = dict(reps=reps, ms=ms, launches=n,
                      ns_per_pair=ms * 1e6 / pairs, ops_per_pair=OPS[v],
                      share_f32_peak=share,
                      share_issue=share / issue_ceiling(v),
                      event_ms=event_ms, ms_at_reps=ms64)
    return out


def _cuobjdump():
    from neuralmelting_tpu_torch.ops import _build
    return str(Path(_build.nvcc()).with_name("cuobjdump"))


def loop_counts(sass):
    """(arithmetic, other) instructions of the pass loop in one kernel's
    SASS listing: the innermost loop (a backward branch) with the most
    arithmetic instructions; NOPs not counted."""
    insts, labels = [], {}
    pending = []
    for line in sass.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for p in pending:
            labels[p] = addr
        pending = []
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
        insts.append((addr, text.split()[0] if text else "", text))
    loops = []
    for addr, op, text in insts:
        if not op.startswith("BRA"):
            continue
        t = re.search(r"\((\.L_x_\d+)\)", text)
        tgt = labels.get(t.group(1)) if t else None
        if tgt is None:
            h = re.search(r"0x([0-9a-f]+)", text)
            tgt = int(h.group(1), 16) if h else None
        if tgt is not None and tgt <= addr:
            loops.append((tgt, addr))
    inner = [(lo, hi) for lo, hi in loops if not any(
        (lo2, hi2) != (lo, hi) and lo <= lo2 and hi2 <= hi
        for lo2, hi2 in loops)]
    best = (0, 0)
    for lo, hi in inner:
        ops = [op.split(".")[0] for addr, op, _ in insts
               if lo <= addr <= hi and op.split(".")[0] != "NOP"]
        arith = sum(o in ARITH_OPS for o in ops)
        if arith > best[0]:
            best = (arith, len(ops) - arith)
    return best


def sass_counts():
    """Per variant: dict(arith, other, ceiling): the arithmetic and the
    other instructions a pass of its pass loop (the loop's count over
    unroll()), from ``cuobjdump -sass`` of the built library, and the
    share of 67 TFLOP/s at one instruction issued a cycle:
    ``issue_ceiling`` x OPS / (arith + other)."""
    from neuralmelting_tpu_torch.ops import _build
    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"probe_(?:f32|bf16)ILi(\d+)E", body.split("\n", 1)[0])
        if not m:
            continue
        v = VARIANTS[int(m.group(1))]
        arith, other = loop_counts(body)
        arith, other = arith / unroll(), other / unroll()
        out[v] = dict(arith=arith, other=other,
                      ceiling=issue_ceiling(v) * OPS[v]
                      / max(arith + other, 1e-9))
    return out


def sm_clocks(fn):
    """(fn(), the SM clocks in MHz that nvidia-smi samples every 50 ms
    while fn runs, and the card's maximum SM clock; both empty where
    nvidia-smi reads none)."""
    q = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "50"]
    with tempfile.TemporaryFile("w+") as f:
        proc = subprocess.Popen(q, stdout=f, stderr=subprocess.DEVNULL,
                                text=True)
        try:
            out = fn()
        finally:
            proc.terminate()
            proc.wait(timeout=60)
        f.seek(0)
        rows = [line.split(",") for line in f.read().splitlines()
                if re.fullmatch(r"\s*\d+\s*,\s*\d+\s*", line)]
    return out, sorted(int(r[0]) for r in rows), [int(r[1]) for r in rows]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the probe runs on the card: no CUDA device")
    sass = sass_counts()
    res, sm, top = sm_clocks(measure)
    print("SM clock while timing (nvidia-smi every 50 ms): " + (
        f"median {sm[len(sm) // 2]} MHz, range {sm[0]}-{sm[-1]} MHz, of a "
        f"maximum {top[0]} MHz" if sm else "not measured"))
    for v, r in res.items():
        c = sass.get(v, dict(arith=float("nan"), other=float("nan"),
                             ceiling=float("nan")))
        print(f"{v:14s} reps {r['reps']:6d} {r['ms']:8.4f} ms/launch on "
              f"the device ({r['event_ms']:.4f} as issued, "
              f"{r['launches']} launches) {r['ns_per_pair']:8.5f} ns/pair  "
              f"{r['ops_per_pair']:3d} ops/pair, SASS a pass "
              f"{c['arith']:.3f} arith + {c['other']:.3f} other  "
              f"{100 * r['share_f32_peak']:6.2f}% of 67 TFLOP/s, "
              f"{100 * r['share_issue']:6.2f}% of the -fmad=false issue "
              f"ceiling (SASS bound {100 * c['ceiling']:.2f}% of 67 "
              f"TFLOP/s)")


if __name__ == "__main__":
    main()
