"""Device time by kernel over one sampling chunk of the PyTorch/CUDA port.

    python3 -m neuralmelting_tpu_torch.profile_chunk          # both paths
    python3 -m neuralmelting_tpu_torch.profile_chunk eam      # or: lj
    python3 -m neuralmelting_tpu_torch.profile_chunk serial   # config 1
    python3 -m neuralmelting_tpu_torch.profile_chunk gather dense

LJ runs the north-star configuration (bench.py: 4096 atoms, 32x32 (P,T)
grid, R=1024), EAM scripts/eambench.py's (4096 Al atoms, 16x16 grid,
R=256, the rc=3.8 synthetic table written to a temp directory). For
each: set up on the card, run one warm-up chunk of 4 records x 8 sweeps
(the slot capacity settles there), then one more chunk under
torch.profiler. Prints the chunk's wall time and attempted moves/s, the
device time of every kernel (calls, total ms, share of the device's busy
time) and the device's idle share, 1 - busy / wall, with the card's name
and power limit.

``gather`` and ``dense`` take the engine of that name at the LJ
validation configuration (docs/VALIDATION.md: 256 atoms, a 2x12 grid,
seed 7), a warm-up chunk of 2 records x 20 sweeps (it compiles and
captures the CUDA graphs), then one record block of 20 sweeps under
torch.profiler: the same lines, and the device kernels a sweep.

``serial`` takes BASELINE config 1's serial chain instead
(``golden.setup_chain``: 256 LJ atoms), one warm-up sweep, then one sweep
under torch.profiler: wall, device busy, idle share, device operations an
attempt and the most launched kernels (launches, device ms), by functor
for torch's elementwise kernels; then one more sweep under cProfile, the
port's functions by cumulative host time (cProfile's own cost inflates
that sweep's wall). Needs a CUDA device; imports nothing of jax.
"""

from __future__ import annotations

import cProfile
import os
import pstats
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from neuralmelting_tpu_torch import golden, runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models import eam_gen


def configs():
    """The full-width configurations of this module and chip_smoke.py:
    LJ at the north star (bench.py), EAM at scripts/eambench.py's, each
    with a short schedule of 4 records x 8 sweeps."""
    lin = lambda a, b, n: tuple(float(v) for v in np.linspace(a, b, n))
    return {
        "lj": RunConfig(name="smoke", element="LJ", ncells=(16, 8, 8),
                        npress=32, ntemp=32, press=lin(1.0, 8.0, 32),
                        temp=lin(0.7, 1.3, 32), nsmpl=4, mod=8, ncut=1,
                        seed=1234, dpos0=0.11, dvol0=0.002),
        "eam": RunConfig(name="eamsmoke", element="AL", ncells=(16, 8, 8),
                         npress=16, ntemp=16, press=lin(1.0, 5000.0, 16),
                         temp=lin(600.0, 1400.0, 16), nsmpl=4, mod=8,
                         ncut=1, seed=11, dpos0=0.15, dvol0=0.002),
    }


def validation_cfg(nsmpl):
    """docs/VALIDATION.md's LJ configuration (chip_smoke's physics phases,
    seed 7) at ``nsmpl`` records of 20 sweeps."""
    return RunConfig(name="val", element="LJ", ncells=(4, 4, 4), npress=2,
                     ntemp=12, press=(1.0, 5.0),
                     temp=tuple(np.linspace(0.55, 1.45, 12)), nsmpl=nsmpl,
                     mod=20, ncut=0, seed=7, dpos0=0.1, dvol0=0.01)


def _device_ms(ev):
    t = getattr(ev, "self_device_time_total", None)
    if t is None:
        t = ev.self_cuda_time_total
    return t / 1e3


def profile_chunk(tag, cfg, setfl, engine="cellmc"):
    setup = runner.setup_run(cfg, setfl=setfl, engine=engine)
    setup = runner.run_sampling(setup, write_files=False,
                                write_traj=False)[0]          # warm-up
    torch.cuda.synchronize()
    tried0 = int(setup.moves_tried)
    nrecords = 1 if engine != "cellmc" else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        setup, _recs, _fr, _hist, _xacc, diag = runner.run_sampling(
            setup, nrecords=nrecords, write_files=False, write_traj=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(ev.key, ev.count, _device_ms(ev))
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and _device_ms(ev) > 0]
    busy = sum(r[2] for r in rows)
    moves = int(setup.moves_tried) - tried0
    if engine == "cellmc":
        what = (f"{cfg.nsmpl} records x {cfg.mod} sweeps", f"K="
                f"{setup.geom.kcap}, cells {setup.geom.ncell}")
    else:
        what = (f"1 record x {cfg.mod} sweeps ({engine})",
                f"{sum(r[1] for r in rows) / cfg.mod:.1f} device kernels a "
                f"sweep, cells {setup.cellcfg.ncell}")
    print(f"[{tag}] chunk of {what[0]}: wall {wall * 1e3:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1.0 - busy / (wall * 1e3):.4f}, "
          f"diag {diag}, {what[1]}, {moves} attempted moves, "
          f"{moves / wall:.4e} moves/s", flush=True)
    if busy <= 0:
        raise SystemExit(f"[{tag}] the profiler saw no device time")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"[{tag}]   {ms:10.3f} ms {100 * ms / busy:6.2f}%  {count:6d} "
              f"x  {key[:90]}", flush=True)


def kernel_label(key):
    """A short name of a profiler kernel key: an elementwise kernel's
    functor or implementing function, else the kernel's own name."""
    for pat in (r"(\w*Functor\w*)<", r"::(\w+_(?:kernel_impl|kernel_cuda))\b"):
        found = re.findall(pat, key)
        if found:
            return found[-1]
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].split("<")[0].strip()


def profile_serial():
    pot, state, sweep = golden.setup_chain("cuda")
    sweep(pot, state)                                          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sweep(pot, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and _device_ms(ev) > 0:
            c, ms = by_name.get(kernel_label(ev.key), (0, 0.0))
            by_name[kernel_label(ev.key)] = (c + ev.count,
                                             ms + _device_ms(ev))
    busy = sum(ms for _, ms in by_name.values())
    if busy <= 0:
        raise SystemExit("[serial] the profiler saw no device time")
    n = state.pos.shape[0]
    print(f"[serial] one sweep of {n} attempts: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1.0 - busy / wall:.4f}, "
          f"{sum(c for c, _ in by_name.values()) / n:.2f} device operations "
          f"an attempt", flush=True)
    for k, (c, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[serial]   {c:6d} x {ms:9.3f} ms  {k}", flush=True)
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    sweep(pot, state)
    torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t) * 1e3
    rows = sorted(((ct * 1e3, nc, f"{os.path.basename(fn)}:{func}")
                   for (fn, _, func), (_, nc, _, ct, _)
                   in pstats.Stats(prof).stats.items()
                   if "neuralmelting_tpu_torch" in fn), reverse=True)
    print(f"[serial] one more sweep under cProfile, wall {wall:.1f} ms; the "
          f"port's functions by cumulative ms (calls):", flush=True)
    for ms, nc, f in rows[:10]:
        print(f"[serial]   {ms:8.1f} ms ({nc:5d})  {f}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_chunk: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    table = os.path.join(tempfile.mkdtemp(prefix="nm_prof_"),
                         "al38.eam.alloy")
    eam_gen.write_setfl(table, rc=3.8)
    cfgs = configs()
    for tag in sys.argv[1:] or ["lj", "eam"]:
        if tag == "serial":
            profile_serial()
        elif tag in ("gather", "dense"):
            profile_chunk(tag, validation_cfg(2), None, engine=tag)
        else:
            profile_chunk(tag, cfgs[tag], table if tag == "eam" else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
