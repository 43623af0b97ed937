"""On-GPU smoke run of the PyTorch/CUDA port (neuralmelting_tpu_torch).

    python3 chip_smoke.py                     # one GPU

Phases, in order (any failed check exits non-zero):
  1. build   — compile the CUDA kernels from neuralmelting_tpu_torch/csrc;
  2. small   — B1 (total) and B2 (sweep) kernels against their plain
               PyTorch versions at the rc=1.5 test geometry, R=3 and R=130
               (two 128-replica threefry tiles);
  3. full    — the same at the north-star geometry: LJ, 4096 atoms
               (16x8x8 fcc cells), a 32x32 (P,T) grid, R=1024; CUDA-event
               times of each kernel beside its plain version;
  4. main    — melting_pipeline(engine="cellmc", device="cuda") at that
               configuration with a short schedule; launch counters are
               zeroed before and read after, and each kernel must have run;
  5. physics — the docs/VALIDATION.md LJ config (256 atoms, P*=(1,5),
               12 temperatures) through the port: T_m(P*=1) against 0.78.

The last lines are the card's name and power limit (nvidia-smi), the
kernels' JSON line, and {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result. Imports nothing of jax.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import _build
from neuralmelting_tpu_torch.ops import cellmc as CK
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.pipeline import melting_pipeline
from neuralmelting_tpu_torch.sampler import cellmc as SC

DEV = torch.device("cuda")
KERNELS = {
    "sweep": dict(name="cellmc_sweep (B2)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/cellmc_sweep.cu",
                  replaces="neuralmelting_tpu/ops/pallas/cellmc.py:460"),
    "total": dict(name="cellmc_total (B1)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/cellmc_total.cu",
                  replaces="neuralmelting_tpu/ops/pallas/cellmc.py:743"),
}
ERR = {"sweep": 0.0, "total": 0.0}
TIMES = {}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def small_case(r, rc=1.5, seed=0, nsub=16):
    """Jittered 256-atom fcc replicas binned at the rc=1.5 geometry."""
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), 4)
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + 0.05 * g.standard_normal(pos.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    boxes = np.repeat(box[None], r, 0)
    geom = CG.make_geom(box, rc, pos.shape[1], nsub=nsub)
    shift = torch.tensor([0.3, 0.05, 0.55], device=DEV)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos, device=DEV),
        torch.as_tensor(boxes, device=DEV), shift)
    check(not bool(over), "small case overflows its slots")
    temps = np.linspace(0.6, 1.8, r).astype(np.float32)
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = np.concatenate([(1.0 / temps)[:, None],
                             np.full((r, 1), 0.15, np.float32), w, boxes], 1)
    pot3 = torch.tensor([1.0, 1.0, rc, 0.0], device=DEV)
    return geom, (x, y, z), ids, count, \
        torch.as_tensor(params, device=DEV), pot3


def full_setup():
    cfg = RunConfig(
        name="smoke", element="LJ", ncells=(16, 8, 8),     # 4096 atoms
        npress=32, ntemp=32,
        press=tuple(float(p) for p in np.linspace(1.0, 8.0, 32)),
        temp=tuple(float(t) for t in np.linspace(0.7, 1.3, 32)),
        nsmpl=4, mod=8, ncut=1, seed=1234, dpos0=0.11, dvol0=0.002)
    return cfg


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------

def energies(geom, slabs, params, pot3):
    r = slabs[0].shape[0]
    ones = torch.ones(r, device=DEV)
    sums = CK.total(geom, slabs, params, pot3, ones)
    return CK.combine_sums(sums, float(pot3[0]), ones)[0], sums


def compare_total(geom, slabs, params, pot3, tag):
    r = slabs[0].shape[0]
    scale = torch.linspace(0.98, 1.02, r, device=DEV)
    k = CK.total(geom, slabs, params, pot3, scale)
    p = CK.total_plain(geom, slabs, params, pot3, scale)
    torch.cuda.synchronize()
    rel = float(((k[:, :4] - p[:, :4]).abs() / p[:, :4].abs()).max())
    ERR["total"] = max(ERR["total"], float((k - p).abs().max()))
    log(f"[{tag}] total R={r}: max rel err of sums {rel:.3e} "
        f"(limit 1e-5), max abs {float((k - p).abs().max()):.3e}")
    check(rel <= 1e-5, f"[{tag}] total kernel disagrees: rel {rel}")
    check(bool((k[:, 4:] == 0).all()), f"[{tag}] total rows 4-7 not zero")


def compare_sweep(geom, slabs, ids, count, params, pot3, rt, tag, exact,
                  ncyc=1):
    """One sweep by the kernel and by the plain version from the same
    slabs; returns the kernel's slabs and stats."""
    r = slabs[0].shape[0]
    ntiles = -(-r // rt)
    seeds = SC.tile_seeds((4242, 17), 3, ntiles, DEV)
    ks = tuple(a.clone() for a in slabs)
    ps = tuple(a.clone() for a in slabs)
    e0, _ = energies(geom, slabs, params, pot3)
    kst = CK.sweep(geom, ncyc, rt, ks, count, params, pot3, seeds)
    pst = CK.sweep_plain(geom, ncyc, rt, ps, count, params, pot3, seeds)
    torch.cuda.synchronize()
    e1, sums1 = energies(geom, ks, params, pot3)
    valid = ids >= 0
    dpos = max(float((a - b)[valid].abs().max()) for a, b in zip(ks, ps))
    ntry_eq = bool(torch.equal(kst[:, 2], pst[:, 2]))
    nacc_k, nacc_p = float(kst[:, 1].sum()), float(pst[:, 1].sum())
    nacc_rel = abs(nacc_k - nacc_p) / max(nacc_p, 1.0)
    dde = float((kst[:, 0] - pst[:, 0]).abs().max())
    tracked = kst[:, 0].double()
    true = (e1 - e0).double()
    # E(final) - E(initial) from two f32 pair-sum totals carries their
    # rounding: a few ulps of S12o + S6o
    tol = 5e-3 + 1e-4 * true.abs() + 2.0 ** -21 * (sums1[:, 0] + sums1[:, 1])
    bad = int(((tracked - true).abs() > tol).sum())
    log(f"[{tag}] sweep R={r} rt={rt}: n_try equal {ntry_eq}, n_acc kernel "
        f"{nacc_k:.0f} plain {nacc_p:.0f} (rel {nacc_rel:.2e}), max |dx| "
        f"{dpos:.3e}, max |dE_k - dE_p| {dde:.3e}, pe identity misses "
        f"{bad}/{r} (max |tracked - true| "
        f"{float((tracked - true).abs().max()):.3e})")
    check(ntry_eq, f"[{tag}] n_try differs")
    check(bad == 0, f"[{tag}] pe identity fails on {bad} replicas")
    wv = params[:, 2:5]
    tabs = torch.as_tensor(CG.geom_tables(geom), device=DEV)
    for a in range(3):
        lo = tabs[a][None].to(torch.float32) * wv[:, a, None]
        out = valid & ((ks[a] < lo) | (ks[a] >= lo + wv[:, a, None]))
        check(not bool(out.any()), f"[{tag}] an atom left its cell")
    if exact:
        check(nacc_k == nacc_p and dpos <= 1e-6 and dde <= 1e-4,
              f"[{tag}] decisions differ: n_acc {nacc_k} vs {nacc_p}, "
              f"|dx| {dpos}, |dE| {dde}")
        ERR["sweep"] = max(ERR["sweep"], dpos)
    else:
        check(nacc_rel <= 1e-5, f"[{tag}] n_acc rel {nacc_rel} > 1e-5")
    return ks, kst


def cuda_ms(fn, reps):
    fn()                                         # warm-up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    t = time.perf_counter()
    _build.build()
    ver = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"[build] {time.perf_counter() - t:.1f} s; nvcc: {ver[-1]}; torch "
        f"{torch.__version__} (CUDA {torch.version.cuda}); "
        f"python {sys.version.split()[0]}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line:
            log(f"[build] {line.strip()}")


def phase_small():
    for r in (3, 130):
        geom, slabs, ids, count, params, pot3 = small_case(r)
        rt = SC.pick_rt(r)
        log(f"[small] geom ncell={geom.ncell} K={geom.kcap} J={geom.nsub} "
            f"R={r} rt={rt} tiles={-(-r // rt)}")
        compare_total(geom, slabs, params, pot3, "small")
        compare_sweep(geom, slabs, ids, count, params, pot3, rt, "small",
                      exact=True)


def phase_full(name):
    cfg = full_setup()
    setup = runner.setup_run(cfg, engine="cellmc", device=DEV)
    geom = setup.geom
    r = setup.states.temp.shape[0]
    rt = SC.pick_rt(r)
    ncyc = SC.default_ncyc(geom)
    params = SC.params_of(setup.states, geom, setup.us.kb)
    pot3 = setup.pot.pot3(DEV)
    slabs = setup.slabs[:3]
    log(f"[full] geom ncell={geom.ncell} K={geom.kcap} J={geom.nsub} "
        f"ncyc={ncyc} R={r} natoms={geom.natoms}")
    compare_total(geom, slabs, params, pot3, "full")
    ks, _ = compare_sweep(geom, slabs, setup.slabs[3], setup.slab_count,
                          params, pot3, rt, "full", exact=False, ncyc=ncyc)
    compare_total(geom, ks, params, pot3, "full, after a sweep")
    seeds = SC.tile_seeds((1, 2), 0, -(-r // rt), DEV)
    ones = torch.ones(r, device=DEV)
    work = tuple(a.clone() for a in slabs)
    TIMES["sweep"] = (
        cuda_ms(lambda: CK.sweep(geom, ncyc, rt, work, setup.slab_count,
                                 params, pot3, seeds), 5),
        cuda_ms(lambda: CK.sweep_plain(geom, ncyc, rt, work,
                                       setup.slab_count, params, pot3,
                                       seeds), 2))
    TIMES["total"] = (
        cuda_ms(lambda: CK.total(geom, slabs, params, pot3, ones), 10),
        cuda_ms(lambda: CK.total_plain(geom, slabs, params, pot3, ones), 3))
    for k, (ms, pms) in TIMES.items():
        log(f"[full] {k}: kernel {ms:.3f} ms, plain {pms:.3f} ms per call "
            f"(R={r}, CUDA events after warm-up) on {name}")


def phase_main(name):
    cfg = full_setup()
    CK.reset_launches()
    res = melting_pipeline(cfg, nbins=64, model="cnn", epochs=100,
                           engine="cellmc", device="cuda")
    launches = dict(CK.LAUNCHES)
    for k in KERNELS:
        KERNELS[k]["launches"] = launches[k]
    s = res.seconds
    rate = res.moves_tried / s["sampling"]
    log(f"[main] diag={res.diag} launches={launches} moves_tried="
        f"{res.moves_tried} T_m(P) first/last={res.tm[0]:.4f}/"
        f"{res.tm[-1]:.4f}")
    log(f"[main] attempted moves/s {rate:.4e} (sampling incl. setup "
        f"{s['sampling']:.3f} s, features {s['features']:.3f} s, classifier "
        f"{s['classifier']:.3f} s) on {name}")
    check(res.diag == 0, f"[main] diag {res.diag}")
    check(all(v > 0 for v in launches.values()),
          f"[main] a kernel never launched: {launches}")
    check(np.isfinite(res.tm).all() and np.isfinite(res.probs).all(),
          "[main] non-finite T_m or probabilities")
    check(res.probs.shape == (32, 32) and res.g_slot.shape == (1024, 64),
          "[main] output shapes")
    check(np.isfinite(res.g_slot).all() and np.isfinite(res.sq_slot).all(),
          "[main] non-finite features")
    pe = res.records.pe.cpu().numpy() / 4096
    check(np.isfinite(pe).all() and (pe < 0).all(),
          "[main] record pe/N not finite and negative")


def phase_physics(name):
    cfg = RunConfig(name="val", element="LJ", ncells=(4, 4, 4), npress=2,
                    ntemp=12, press=(1.0, 5.0),
                    temp=tuple(np.linspace(0.55, 1.45, 12)), nsmpl=40,
                    mod=20, ncut=15, seed=7, dpos0=0.1, dvol0=0.01)
    t = time.perf_counter()
    res = melting_pipeline(cfg, nbins=48, model="mlp", epochs=400, band=2,
                           engine="cellmc", device="cuda")
    dt = time.perf_counter() - t
    tm1 = float(res.tm[0])
    err = abs(tm1 / 0.78 - 1.0)
    log(f"[physics] T_m(P*=1)={tm1:.4f} T_m(P*=5)={float(res.tm[1]):.4f} "
        f"diag={res.diag}; |T_m(1)/0.78 - 1| = {err:.4f} "
        f"(gate 0.02: {'PASS' if err <= 0.02 else 'MISS'}); {dt:.1f} s "
        f"on {name}")
    check(res.diag == 0 and math.isfinite(tm1), "[physics] diag/T_m")
    check(err <= 0.02, f"[physics] T_m(P*=1)={tm1} misses the 2% gate")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    log(f"[card] {name}; torch.cuda.get_device_name(0)="
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    for ph, fn in (("build", phase_build), ("small", phase_small),
                   ("full", lambda: phase_full(name)),
                   ("main", lambda: phase_main(name)),
                   ("physics", lambda: phase_physics(name))):
        t = time.perf_counter()
        fn()
        log(f"[{ph}] done in {time.perf_counter() - t:.1f} s")
    check("jax" not in sys.modules, "jax was imported")
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    kern = []
    for k, meta in KERNELS.items():
        ms, pms = TIMES[k]
        kern.append(dict(meta, max_abs_err=ERR[k], ms=ms, plain_ms=pms))
    print(name)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
