"""How often torch.profiler loses the records of B5's run kernel on the
card: the session ``probe.device_ms`` runs, many times in one process.

    python3 -m neuralmelting_tpu_torch.profiler_drops

Each session profiles 5 launches of the run kernel (``ops/lj_delta.py``,
256 attempts at 4096 atoms, ~6 ms a launch) and counts the launches it
recorded: 1200 sessions in each of six processes, after three such
sessions and a set-up that differs by process. "plain" makes no CUDA
graph. The others first run a gather chunk (256 atoms, 8 replicas) whose
stages are captured as CUDA graphs, then: "kept" profiles one more chunk
and keeps the graphs; "freed" runs one more chunk unprofiled and frees
them; "profiled-freed" profiles one more chunk and frees them;
"keep-cupti" does that with TEARDOWN_CUPTI=0 (CUPTI stays up between
sessions, as torch.profiler sets it for Inductor's graphs); "warmup"
does it with a warm-up step of the profiler's schedule before every
session. Prints each session that recorded fewer than 5, then one JSON
line a process.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import lj_delta as LD
from neuralmelting_tpu_torch.ops.energy import pair_energy_virial

CALLS = 5
SESSIONS = 1200
VARIANTS = ("plain", "kept", "freed", "profiled-freed", "keep-cupti",
            "warmup")


def kernel_counts(prof, match):
    """(launches of kernels whose name holds ``match``, all kernels)."""
    n = every = 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            every += ev.count
            if match in ev.key:
                n += ev.count
    return n, every


def session(fn, warmup, acts=(ProfilerActivity.CUDA,), calls=CALLS):
    """One profiler session over ``calls`` calls of ``fn``, as device_ms
    runs it (with ``warmup``: after a warm-up step of the schedule)."""
    fn()
    torch.cuda.synchronize()
    kw = dict(schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
        if warmup else {}
    with profile(activities=list(acts), **kw) as prof:
        if warmup:
            prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if warmup:
            prof.step()
    return prof


def b5_run(dev):
    """The run-kernel call: 256 attempts on a jittered 4096-atom fcc."""
    pot = LJCut.create()
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), (16, 8, 8))
    g = np.random.default_rng(4)
    pos = ((pos + 0.03 * g.standard_normal(pos.shape)) % box)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    box = torch.as_tensor(box, dtype=torch.float32, device=dev)
    pe, vir = pair_energy_virial(pot, pos, box)
    ids = torch.as_tensor(g.integers(0, 4096, 256).astype(np.int32),
                          device=dev)
    disp = torch.as_tensor(g.uniform(-0.12, 0.12, (256, 3)),
                           dtype=torch.float32, device=dev)
    lnu = torch.as_tensor(np.log(g.uniform(1e-6, 1.0, 256)),
                          dtype=torch.float32, device=dev)
    nbeta = torch.tensor(-1.0 / 0.8, dtype=torch.float32, device=dev)
    return lambda: LD.position_run(pot, pos.clone(), box, ids, disp, lnu,
                                   nbeta, pe.clone(), vir.clone())


def gather_graphs(dev, variant, warmup):
    """Capture a gather chunk's CUDA graphs and run one more chunk,
    profiled unless ``variant`` is "freed"; free the graphs unless it is
    "kept". Returns (the setup while kept, the kernels the profiled
    chunk recorded)."""
    cfg = RunConfig(name="drops", element="LJ", ncells=(4, 4, 4), npress=2,
                    ntemp=4, nsmpl=2, mod=2, ncut=0, seed=3)
    setup = [runner.setup_run(cfg, device=dev)]

    def chunk():
        setup[0] = runner.run_sampling(setup[0], write_files=False)[0]
    every = None
    if variant == "freed":
        chunk()
        chunk()
    else:
        every = kernel_counts(session(chunk, warmup, (
            ProfilerActivity.CPU, ProfilerActivity.CUDA), calls=1), "")[1]
    if variant == "kept":
        return setup[0], every
    del setup[0]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return None, every


def drops(variant):
    """One process: 3 sessions, the variant's set-up, SESSIONS sessions."""
    warmup = variant == "warmup"
    dev = torch.device("cuda")
    fn = b5_run(dev)
    before = [kernel_counts(session(fn, warmup), "delta_run")[0]
              for _ in range(3)]
    if variant == "keep-cupti":
        os.environ["TEARDOWN_CUPTI"] = "0"
    kept, graph_kernels = (None, None) if variant == "plain" \
        else gather_graphs(dev, variant, warmup)
    short = empty = 0
    for i in range(SESSIONS):
        n, every = kernel_counts(session(fn, warmup), "delta_run")
        if n < CALLS:
            short += 1
            empty += n == 0
            print(f"[{variant}] session {i}: {n} of {CALLS} launches "
                  f"recorded, {every} kernels in all", flush=True)
    print(json.dumps({
        "variant": variant, "torch": torch.__version__,
        "cuda": torch.version.cuda, "before": before,
        "graph_session_kernels": graph_kernels, "sessions": SESSIONS,
        "short": short, "empty": empty}), flush=True)


def main():
    if len(sys.argv) > 1:
        drops(sys.argv[1])
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    for variant in VARIANTS:
        subprocess.run([sys.executable, "-m", __spec__.name, variant],
                       check=True)


if __name__ == "__main__":
    main()
