"""On-GPU smoke run of the PyTorch/CUDA port (neuralmelting_tpu_torch).

    python3 chip_smoke.py                     # one GPU

Phases, in order (any failed check exits non-zero):
  1. build       — compile the CUDA kernels from neuralmelting_tpu_torch/csrc
                   (one nvcc per source, all at once, then one link);
  LJ path (kernels B1 total, B2 sweep):
  2. small       — B1 and B2 against their plain PyTorch versions at the
                   rc=1.5 test geometry, R=3 and R=130 (two 128-replica
                   threefry tiles);
  3. full        — the same at the north-star geometry: LJ, 4096 atoms
                   (16x8x8 fcc cells), a 32x32 (P,T) grid, R=1024; CUDA-event
                   times of each kernel beside its plain version;
  4. main        — melting_pipeline(engine="cellmc") on the default device
                   (the card) at that configuration with a short schedule;
                   B1/B2 launch counters are zeroed before and read after,
                   and each kernel must have run;
  5. physics     — the docs/VALIDATION.md LJ config (256 atoms, P*=(1,5),
                   12 temperatures) through the port: T_m(P*=1) against 0.78;
  EAM path (kernels B3 sweep, B4 total; the rc=3.8 synthetic Al table,
  written to a temp directory at run time):
  6. eam-small   — B4 and B3 against their plain versions at 4x4x4 fcc Al
                   (cells (3,3,3), K=16), R=3 and R=130 (rt=128, two tiles):
                   identical decisions, the density slab, the pe identity
                   against fresh B4 totals, every atom inside its cell;
  7. eam-full    — the same at scripts/eambench.py's configuration (AL,
                   16x8x8 fcc = 4096 atoms, 16x16 grid, R=256, seed 11);
                   CUDA-event times of each kernel beside its plain version;
  8. eam-main    — melting_pipeline(element="AL", engine="cellmc") on the
                   default device at that configuration with a short
                   schedule; B3/B4 counters zeroed before and read after;
  9. eam-physics — docs/VALIDATION.md config 3, the heating leg as
                   scripts/eam_tm_ab.py pins it, as 8 chains (seeds 5-12)
                   held to the JAX gather engine's chains of the same
                   seeds (eam_config3_gather.json): per slot pe/N, V and
                   the virial pressure, and T_m of one classifier
                   trained on either side's features, each within 4
                   standard errors; diag 0 and T_m inside the grid.
  Serial path (kernel B5 lj_delta) and the probe (kernel P1):
  10. serial-small — B5 against its plain version, dE and dW, at the JAX
                   kernel test's shapes (R=1, N=256, M=4; R=2, N=108, M=2);
  11. serial-full  — the same at the serial engine's own launch (R=1,
                   N=256, M=1) and batched at BASELINE config 2's shape
                   (R=64 replicas of 4096 perturbed fcc atoms, M=32, rc
                   2.5), with CUDA-event times and the bound;
  12. golden      — BASELINE config 1 (tests/make_golden.py) through the
                   port's serial engine on the default device (the card),
                   B5's counter zeroed before and read after: it must equal
                   the position attempts; records and frames held to the
                   committed tests/golden/config1.* (the JAX package's run)
                   and every decision to the port's own CPU run of it;
                   seconds per sweep and attempted moves/s;
  13. golden-hmc  — tests/test_golden.py's HMC case (32 atoms, ppos 0.7,
                   pvol 0.05, seed 9) on the card against the port's CPU
                   run: acceptance ratios equal, positions within 1e-2;
  14. probe       — every P1 variant against its plain version, then the
                   per-variant timing (python -m neuralmelting_tpu_torch.probe).

The last lines are the card's name and power limit (nvidia-smi), the
kernels' JSON line (each kernel's launches on its path's main run, error
against its plain version, CUDA-event ms of kernel and plain version at
full width, and the least time the card could take for that work,
bound_ms, from its bytes over 3.35 TB/s or its f32 operations over
67 TFLOP/s, whichever is larger), and {"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside this script, it
exits non-zero and prints no result. Imports nothing of jax or of the JAX
package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from neuralmelting_tpu_torch import golden as GOLD
from neuralmelting_tpu_torch import probe as P1
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.io import thermo, traj
from neuralmelting_tpu_torch.models import eam as eam_mod
from neuralmelting_tpu_torch.models import eam_cheb, eam_gen
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.neural.melt import melting_curve
from neuralmelting_tpu_torch.neural.models import PhaseCNN, init_params
from neuralmelting_tpu_torch.neural.scalers import get_scaler
from neuralmelting_tpu_torch.neural.train import (extreme_t_labels,
                                                  train_classifier)
from neuralmelting_tpu_torch.ops import _build
from neuralmelting_tpu_torch.ops import cellmc as CK
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.ops import lj_delta as LD
from neuralmelting_tpu_torch.ops.energy import min_image
from neuralmelting_tpu_torch.pipeline import melting_pipeline
from neuralmelting_tpu_torch.profile_chunk import configs
from neuralmelting_tpu_torch.sampler import cellmc as SC

DEV = torch.device("cuda")
FULL = configs()     # LJ north star, EAM eambench: 4096 atoms each
KERNELS = {
    "sweep": dict(name="cellmc_sweep (B2)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/cellmc_sweep.cu",
                  replaces="neuralmelting_tpu/ops/pallas/cellmc.py:460"),
    "total": dict(name="cellmc_total (B1)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/cellmc_total.cu",
                  replaces="neuralmelting_tpu/ops/pallas/cellmc.py:743"),
    "eam_sweep": dict(
        name="cellmc_eam_sweep (B3)", route="cuda",
        source="neuralmelting_tpu_torch/csrc/cellmc_eam_sweep.cu",
        replaces="neuralmelting_tpu/ops/pallas/cellmc_eam.py:89"),
    "eam_total": dict(
        name="cellmc_eam_total (B4)", route="cuda",
        source="neuralmelting_tpu_torch/csrc/cellmc_eam_total.cu",
        replaces="neuralmelting_tpu/ops/pallas/cellmc_eam.py:351"),
    "delta": dict(name="lj_delta (B5)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/lj_delta.cu",
                  replaces="neuralmelting_tpu/ops/pallas/lj_kernel.py:64"),
    "probe": dict(name="vpu_probe pair_div (P1)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/vpu_probe.cu",
                  replaces="scripts/vpu_probe.py:39"),
}
HERE = os.path.dirname(os.path.abspath(__file__))
# the JAX gather engine's config-3 chains (scripts/eam_config3_reference.py)
REFERENCE = os.path.join(HERE, "eam_config3_gather.json")
# the JAX serial engine's config-1 run (tests/make_golden.py)
GOLDEN = os.path.join(HERE, "tests", "golden")
Z_PHYS = 4.0            # standard errors allowed between port and JAX
CLF_SEEDS = range(4)    # classifier initial weights per chain
KB_EV = 8.617333262e-5
ERR = {k: 0.0 for k in KERNELS}
TIMES = {}
BOUND = {}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 operations/s
# outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12
# f32 operations per pair term, counted from the kernels' code (a divide
# or a square root counts as one, so the bound stays a lower bound):
# LJ total: 3 sub, 5 for r^2, max, divide, 4 mul, 2 compares, 4 adds
OPS_LJ_TOTAL = 20
# LJ sweep: two r^2 (16), one shared divide, the e(new) - e(old) algebra
OPS_LJ_SWEEP = 30
# EAM: one r^2 (8) plus masks and the image shift per candidate pair
# (twice, old and new, in the sweep); a Clenshaw term is 3 operations
OPS_EAM_CAND = 12
OPS_EAM_SWEEP_CAND = 20
# B5, per atom and side: the minimum image (3 x sub, divide, rint, mul,
# sub), r^2 (5) and the cutoff compare; inside rc also max, divide, sr6
# (2), sr12, e (2), w (3) and the two accumulates
OPS_B5_PAIR = 21
OPS_B5_IN = 12
# B5 sums of N terms in another order than the plain version: |k - p| <=
# B5_RTOL * (sum of the terms' magnitudes)
B5_RTOL = 2e-6
# P1 against its plain version, relative to max |plain|: exact for the
# variants whose operations the plain version repeats, the approximate
# reciprocal (square root) for the rest, bf16 rounding for the bf16 ones
PROBE_TOL = {"recip": 1e-4, "recip0": 1e-4, "rsqrt": 1e-4,
             "pair_recip": 1e-4, "fma_peak_bf16": 2.0 ** -5,
             "pair_div_bf16": 2.0 ** -5}


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


STENCIL27 = [(0, 0, 0)] + CG.offsets26()


def stencil_sum(geom, count, offs):
    """(R, C) f64: per cell, the occupied slots of its stencil cells."""
    _, nb, _ = CG.stencil(geom, offs, count.device)
    return count[:, nb].sum(dim=-1).to(torch.float64)


def bound(nbytes, nops):
    """(least ms for this work, what bounds it) on the H100's peaks."""
    t_b, t_o = nbytes / HBM_BPS, nops / F32_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def pairs_within(geom, slabs, params, rc2):
    """Ordered atom pairs closer than the cutoff, all replicas."""
    r, dev = slabs[0].shape[0], slabs[0].device
    c, k = geom.ncells, geom.kcap
    _, nb, img = CG.stencil(geom, STENCIL27, dev)
    v = [a.reshape(r, c, k) for a in slabs]
    n = 0
    for r0 in range(0, r, 4):
        rs = slice(r0, min(r, r0 + 4))
        cand = [(v[a][rs][:, nb, :] + img[..., a].to(torch.float32)[
            None, :, :, None] * params[rs, 5 + a, None, None, None])[
            :, :, None] for a in range(3)]
        mov = [v[a][rs][..., None, None] for a in range(3)]
        d = [cand[a] - mov[a] for a in range(3)]
        u = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        ok = (cand[0] < 1e29) & (mov[0] < 1e29) & (u < rc2) & (u > 0)
        n += int(ok.sum())
    return n


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    t = time.perf_counter()
    lib = _build.build()
    ver = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"[build] {lib.name} in {time.perf_counter() - t:.1f} s; "
        f"nvcc: {ver[-1]}; torch "
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
    cfg = FULL["lj"]
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
    # least time for the same work on these inputs
    cnt = setup.slab_count.to(torch.float64)
    rows = r * geom.rows
    pairs = float((cnt * (cnt - 1) / 2).sum()
                  + (cnt * stencil_sum(geom, setup.slab_count,
                                       CG.offsets13())).sum())
    BOUND["total"] = bound(4 * (3 * rows + 10 * r + 4) + 4 * 8 * r,
                           pairs * OPS_LJ_TOTAL)
    movers = torch.clamp(cnt, max=geom.nsub)
    cand = stencil_sum(geom, setup.slab_count, STENCIL27) - 1.0
    BOUND["sweep"] = bound(
        4 * (2 * 3 * rows + r * geom.ncells + 8 * r + 2 * (-(-r // rt)))
        + 4 * 8 * r, ncyc * float((movers * cand).sum()) * OPS_LJ_SWEEP)
    for k in ("sweep", "total"):
        ms, pms = TIMES[k]
        log(f"[full] {k}: kernel {ms:.3f} ms, plain {pms:.3f} ms per call, "
            f"bound {BOUND[k][0]:.4f} ms ({BOUND[k][1]}) (R={r}, CUDA "
            f"events after warm-up) on {name}")


def phase_main(name):
    cfg = FULL["lj"]
    CK.reset_launches()
    res = melting_pipeline(cfg, nbins=64, model="cnn", epochs=100,
                           engine="cellmc")
    launches = dict(CK.LAUNCHES)
    for k in ("sweep", "total"):
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
                           engine="cellmc")
    dt = time.perf_counter() - t
    tm1 = float(res.tm[0])
    err = abs(tm1 / 0.78 - 1.0)
    log(f"[physics] T_m(P*=1)={tm1:.4f} T_m(P*=5)={float(res.tm[1]):.4f} "
        f"diag={res.diag}; |T_m(1)/0.78 - 1| = {err:.4f} "
        f"(gate 0.02: {'PASS' if err <= 0.02 else 'MISS'}); {dt:.1f} s "
        f"on {name}")
    check(res.diag == 0 and math.isfinite(tm1), "[physics] diag/T_m")
    check(err <= 0.02, f"[physics] T_m(P*=1)={tm1} misses the 2% gate")


# ---------------------------------------------------------------------------
# EAM path
# ---------------------------------------------------------------------------

def eam_table():
    path = os.path.join(tempfile.mkdtemp(prefix="nm_smoke_"),
                        "al38.eam.alloy")
    eam_gen.write_setfl(path, rc=3.8)
    return path


def eam_small_case(cheb, r, seed=0):
    """Jittered 256-atom fcc Al replicas, cells (3,3,3), K=16."""
    pos, box = make_supercell("fcc", 4.05, (4, 4, 4))
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + 0.08 * g.standard_normal(pos.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    boxes = np.repeat(np.asarray(box, np.float32)[None], r, 0)
    geom = CG.make_geom(box, cheb.rc_host, 256, nsub=1, stride=3, kcap=16)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos, device=DEV),
        torch.as_tensor(boxes, device=DEV),
        torch.tensor([0.3, 0.65, 0.11], device=DEV))
    check(not bool(over), "eam small case overflows its slots")
    temps = np.linspace(300.0, 1500.0, r).astype(np.float32)
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = np.concatenate([(1.0 / (8.617333262e-5 * temps))[:, None],
                             np.full((r, 1), 0.15, np.float32), w, boxes], 1)
    return geom, (x, y, z), ids, count, torch.as_tensor(params, device=DEV)


def compare_eam_total(geom, slabs, ids, params, scal, series, tag):
    r = slabs[0].shape[0]
    valid = ids >= 0
    for wv, scale in ((True, torch.ones(r, device=DEV)),
                      (False, torch.linspace(0.98, 1.02, r, device=DEV))):
        k, krho = CE.total(geom, slabs, params, scal, series, scale, wv)
        p, prho = CE.total_plain(geom, slabs, params, scal, series, scale,
                                 wv)
        torch.cuda.synchronize()
        rows = [0, 1, 2, 3, 5, 6] if wv else [0, 2, 3]
        rel = float(((k[:, rows] - p[:, rows]).abs()
                     / p[:, rows].abs().clamp(min=1.0)).max())
        drho = float((krho - prho).abs()[valid].max())
        ERR["eam_total"] = max(ERR["eam_total"], drho)
        log(f"[{tag}] eam total R={r} virial={wv}: max rel err of stats "
            f"{rel:.3e} (limit 1e-5), max |rho_k - rho_p| {drho:.3e} "
            f"(limit 2e-5)")
        check(rel <= 1e-5, f"[{tag}] eam total disagrees: rel {rel}")
        check(drho <= 2e-5, f"[{tag}] eam total rho disagrees: {drho}")
        zero = [4, 7] if wv else [1, 4, 5, 6, 7]
        check(bool((k[:, zero] == 0).all()), f"[{tag}] eam stats rows")


def compare_eam_sweep(geom, slabs, ids, count, params, scal, series, rt,
                      tag, exact, ncyc=1):
    """One B3 sweep by the kernel and by the plain version from the same
    slabs and density slab; returns the kernel's slabs."""
    r = slabs[0].shape[0]
    ones = torch.ones(r, device=DEV)
    st0, rho0 = CE.total(geom, slabs, params, scal, series, ones, False)
    seeds = SC.tile_seeds((4242, 17), 3, -(-r // rt), DEV)
    ks = tuple(a.clone() for a in slabs) + (rho0.clone(),)
    ps = tuple(a.clone() for a in slabs) + (rho0.clone(),)
    kst = CE.sweep(geom, ncyc, rt, ks, count, params, scal, series, seeds)
    pst = CE.sweep_plain(geom, ncyc, rt, ps, count, params, scal, series,
                         seeds)
    torch.cuda.synchronize()
    st1, rho1 = CE.total(geom, ks[:3], params, scal, series, ones, False)
    valid = ids >= 0
    dpos = max(float((a - b)[valid].abs().max())
               for a, b in zip(ks[:3], ps[:3]))
    drho = float((ks[3] - ps[3])[valid].abs().max())
    dfresh = float((ks[3] - rho1)[valid].abs().max())
    ntry_eq = bool(torch.equal(kst[:, 2], pst[:, 2]))
    nacc_k, nacc_p = float(kst[:, 1].sum()), float(pst[:, 1].sum())
    ndiff = int((kst[:, 1] != pst[:, 1]).sum())
    nacc_rel = abs(nacc_k - nacc_p) / max(nacc_p, 1.0)
    tracked = kst[:, 0].double()
    true = (st1[:, 0] - st0[:, 0]).double()
    tol = 5e-3 + 1e-4 * true.abs() + 2.0 ** -21 * st0[:, 0].double().abs()
    bad = int(((tracked - true).abs() > tol).sum())
    log(f"[{tag}] eam sweep R={r} rt={rt} ncyc={ncyc}: n_try equal "
        f"{ntry_eq}, n_acc kernel {nacc_k:.0f} plain {nacc_p:.0f} (rel "
        f"{nacc_rel:.2e}, {ndiff} replicas differ), max |dx| {dpos:.3e}, "
        f"max |rho_k - rho_p| {drho:.3e}, max |rho_k - fresh B4| "
        f"{dfresh:.3e}, pe identity misses {bad}/{r} (max |tracked - "
        f"true| {float((tracked - true).abs().max()):.3e})")
    check(ntry_eq, f"[{tag}] eam n_try differs")
    check(bad == 0, f"[{tag}] eam pe identity fails on {bad} replicas")
    check(dfresh <= 1e-4, f"[{tag}] eam density slab drifted: {dfresh}")
    wv = params[:, 2:5]
    tabs = torch.as_tensor(CG.geom_tables(geom), device=DEV)
    for a in range(3):
        lo = tabs[a][None].to(torch.float32) * wv[:, a, None]
        out = valid & ((ks[a] < lo) | (ks[a] >= lo + wv[:, a, None]))
        check(not bool(out.any()), f"[{tag}] an atom left its cell")
    if exact:
        check(ndiff == 0 and dpos <= 1e-6 and drho <= 2e-5,
              f"[{tag}] eam decisions differ: {ndiff} replicas, |dx| "
              f"{dpos}, |drho| {drho}")
        ERR["eam_sweep"] = max(ERR["eam_sweep"], dpos)
    else:
        check(nacc_rel <= 1e-4, f"[{tag}] eam n_acc rel {nacc_rel} > 1e-4")
    return ks


def phase_eam_small(table):
    cheb = eam_cheb.from_spline(eam_mod.load(table))
    scal, series, nser = CE.eam_pack(cheb, DEV)
    log(f"[eam-small] Chebyshev series lengths {nser}, fit errors "
        f"{cheb.fit_err}")
    for r in (3, 130):
        geom, slabs, ids, count, params = eam_small_case(cheb, r)
        rt = SC.pick_rt(r)
        log(f"[eam-small] geom ncell={geom.ncell} K={geom.kcap} R={r} "
            f"rt={rt} tiles={-(-r // rt)}")
        compare_eam_total(geom, slabs, ids, params, scal, series,
                          "eam-small")
        compare_eam_sweep(geom, slabs, ids, count, params, scal, series, rt,
                          "eam-small", exact=True)


def phase_eam_full(name, table):
    setup = runner.setup_run(FULL["eam"], setfl=table,
                             engine="cellmc", device=DEV)
    geom = setup.geom
    r = setup.states.temp.shape[0]
    rt = SC.pick_rt(r)
    ncyc = SC.default_ncyc(geom)
    params = SC.params_of(setup.states, geom, setup.us.kb)
    scal, series, nser = CE.eam_pack(setup.pot, DEV)
    slabs, ids, count = setup.slabs[:3], setup.slabs[3], setup.slab_count
    log(f"[eam-full] geom ncell={geom.ncell} K={geom.kcap} J={geom.nsub} "
        f"ncyc={ncyc} R={r} natoms={geom.natoms} series {nser}")
    compare_eam_total(geom, slabs, ids, params, scal, series, "eam-full")
    ks = compare_eam_sweep(geom, slabs, ids, count, params, scal, series, rt,
                           "eam-full", exact=False, ncyc=ncyc)
    compare_eam_total(geom, ks[:3], ids, params, scal, series,
                      "eam-full, after a sweep")
    seeds = SC.tile_seeds((1, 2), 0, -(-r // rt), DEV)
    ones = torch.ones(r, device=DEV)
    work = tuple(a.clone() for a in setup.slabs[:3] + setup.slabs[4:])
    TIMES["eam_sweep"] = (
        cuda_ms(lambda: CE.sweep(geom, ncyc, rt, work, count, params, scal,
                                 series, seeds), 3),
        cuda_ms(lambda: CE.sweep_plain(geom, ncyc, rt, work, count, params,
                                       scal, series, seeds), 1))
    TIMES["eam_total"] = (
        cuda_ms(lambda: CE.total(geom, slabs, params, scal, series, ones,
                                 False), 10),
        cuda_ms(lambda: CE.total_plain(geom, slabs, params, scal, series,
                                       ones, False), 1))
    ms_v = cuda_ms(lambda: CE.total(geom, slabs, params, scal, series, ones,
                                    True), 5)
    # least time for the same work on these inputs. B4's phi and rho
    # terms are symmetric in i and j, so a pass needs each unordered
    # candidate pair (half stencil) once and a Clenshaw pair term for
    # each unordered pair inside rc; a B3 trial needs its mover's 27
    # cells at the old and the new position
    cnt = count.to(torch.float64)
    half = float((cnt * (cnt - 1) / 2
                  + cnt * stencil_sum(geom, count, CG.offsets13())).sum())
    cand = stencil_sum(geom, count, STENCIL27) - 1.0
    n_in = pairs_within(geom, slabs, params, float(scal[0]))
    natoms = r * geom.natoms
    nbar = n_in / natoms
    n_phi, n_rho, n_f = nser
    rows = r * geom.rows
    nser_all = 2 * (n_phi + n_rho + n_f)
    BOUND["eam_total"] = bound(
        4 * (3 * rows + 9 * r + 8 + nser_all) + 4 * (8 * r + rows),
        half * OPS_EAM_CAND + n_in / 2 * (n_phi + n_rho) * 3
        + natoms * (3 * n_f + 4))
    occupied = (count > 0).to(torch.float64)
    trials = ncyc * float(occupied.sum())
    BOUND["eam_sweep"] = bound(
        4 * (2 * 4 * rows + r * geom.ncells + 8 * r + 8 + n_phi + n_rho
             + n_f + 2 * (-(-r // rt))) + 4 * 8 * r,
        ncyc * float((occupied * cand).sum()) * OPS_EAM_SWEEP_CAND
        + trials * (2 * nbar * (n_phi + n_rho) * 3 + 2 * nbar * n_f * 3
                    + 2 * n_f * 3))
    log(f"[eam-full] ordered pairs inside rc {n_in} ({nbar:.2f} per "
        f"atom), {trials:.0f} trials per sweep; B4 with the virial "
        f"{ms_v:.3f} ms")
    for k in ("eam_sweep", "eam_total"):
        ms, pms = TIMES[k]
        log(f"[eam-full] {k}: kernel {ms:.3f} ms, plain {pms:.3f} ms per "
            f"call, bound {BOUND[k][0]:.4f} ms ({BOUND[k][1]}) (K="
            f"{geom.kcap}, cells {geom.ncell}, ncyc={ncyc}, R={r}, CUDA "
            f"events after warm-up) on {name}")


def phase_eam_main(name, table):
    cfg = FULL["eam"]
    CE.reset_launches()
    res = melting_pipeline(cfg, setfl=table, nbins=64, model="cnn",
                           epochs=100, engine="cellmc")
    launches = dict(CE.LAUNCHES)
    for k in ("eam_sweep", "eam_total"):
        KERNELS[k]["launches"] = launches[k]
    s = res.seconds
    rate = res.moves_tried / s["sampling"]
    log(f"[eam-main] diag={res.diag} launches={launches} moves_tried="
        f"{res.moves_tried} T_m(P) first/last={res.tm[0]:.1f}/"
        f"{res.tm[-1]:.1f} K")
    log(f"[eam-main] attempted moves/s {rate:.4e} (sampling incl. setup "
        f"{s['sampling']:.3f} s, features {s['features']:.3f} s, classifier "
        f"{s['classifier']:.3f} s) on {name}")
    check(res.diag == 0, f"[eam-main] diag {res.diag}")
    check(all(v > 0 for v in launches.values()),
          f"[eam-main] a kernel never launched: {launches}")
    check(np.isfinite(res.tm).all() and np.isfinite(res.probs).all(),
          "[eam-main] non-finite T_m or probabilities")
    check(res.probs.shape == (16, 16) and res.g_slot.shape == (256, 64),
          "[eam-main] output shapes")
    check(np.isfinite(res.g_slot).all() and np.isfinite(res.sq_slot).all(),
          "[eam-main] non-finite features")
    pe = res.records.pe.cpu().numpy() / 4096
    check(np.isfinite(pe).all() and (pe < -2.5).all() and (pe > -3.5).all(),
          "[eam-main] record pe/N not finite or outside (-3.5, -2.5) eV")


def config3(seed):
    """docs/VALIDATION.md config 3, the heating leg as scripts/eam_tm_ab.py
    pins it, with the chain seed given."""
    return RunConfig(name="eamval", element="AL", ncells=(4, 4, 4),
                     npress=1, ntemp=10, press=(1.0,),
                     temp=tuple(float(t) for t in np.linspace(400.0, 2200.0,
                                                              10)),
                     nsmpl=40, mod=20, ncut=15, dpos0=0.1, dvol0=0.01,
                     seed=seed)


def slot_batches(res, ncut, nbatch, natoms):
    """Per temperature slot, batch means (nbatch, ntemp) of pe/N, V and
    the virial pressure (N kB T + W/3)/V over the records after the
    burn-in, as scripts/eam_config3_reference.py takes them."""
    rec = res.records
    order = torch.argsort(rec.temp, dim=1)

    def take(v):
        return torch.gather(v, 1, order)[ncut:].double().cpu().numpy()

    temp, vol = take(rec.temp), take(rec.vol)
    vals = {"pe_per_atom_eV": take(rec.pe) / natoms, "vol_A3": vol,
            "pvir_eV_per_A3": (natoms * KB_EV * temp + take(rec.virial) / 3.0)
            / vol}
    return {k: np.stack([c.mean(0) for c in np.array_split(v, nbatch)])
            for k, v in vals.items()}


def classifier_tm(g_slot, temp, seeds):
    """Mean T_m over the port's classifier trained on these features from
    each initial-weight seed (the pipeline's recipe: tanh scaler, CNN,
    extreme-T labels, 400 epochs)."""
    x = get_scaler("tanh").fit_transform(
        torch.as_tensor(np.asarray(g_slot), dtype=torch.float32, device=DEV))
    mask, labels = extreme_t_labels(len(temp), 1, device=DEV)
    out = []
    for seed in seeds:
        net = PhaseCNN(x.shape[1]).to(DEV)
        init_params(net, torch.Generator().manual_seed(seed))
        fit = train_classifier(net, x, mask, labels, epochs=400, lr=2e-3)
        tm, _ = melting_curve(temp, fit.probs.cpu().numpy().reshape(1, -1))
        out.append(float(tm[0]))
    return float(np.mean(out))


def phase_eam_physics(name, table):
    """docs/VALIDATION.md config 3 against the JAX gather engine's chains
    of it (eam_config3_gather.json, from scripts/eam_config3_reference.py:
    the same seeds, on the CPU). Gates, with nothing melting in this
    protocol, so that T_m of one chain and one classifier is mostly the
    classifier's initial weights (PERF.md):
    - every chain diag 0 with T_m inside the grid;
    - sampling, no classifier: per slot, pe/N, V and the virial pressure
      pooled over the chains within Z_PHYS standard errors of the JAX
      chains' (batch means of 5 x 5 records per chain on both sides);
    - T_m, one classifier: the port's classifier, trained from seeds 0-3
      on each chain's features, gives the same mean T_m on the port's
      chains as on the JAX chains within Z_PHYS standard errors (from the
      chain-to-chain spread, pooled over both sides)."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    seeds = ref["chain_seeds"]
    temp = np.asarray(ref["temp_K"], np.float32)
    t = time.perf_counter()
    runs = [melting_pipeline(config3(s), setfl=table, engine="cellmc",
                             nbins=ref["nbins"]) for s in seeds]
    for s, res in zip(seeds, runs):
        check(res.diag == 0 and math.isfinite(float(res.tm[0]))
              and temp[0] <= float(res.tm[0]) <= temp[-1],
              f"[eam-physics] chain {s}: diag {res.diag}, T_m {res.tm}")
    batches = [slot_batches(res, config3(0).ncut, ref["batches_per_chain"],
                            ref["natoms"]) for res in runs]
    worst = 0.0
    for key in ("pe_per_atom_eV", "vol_A3", "pvir_eV_per_A3"):
        b = np.concatenate([bt[key] for bt in batches])
        m, se = b.mean(0), b.std(0, ddof=1) / math.sqrt(len(b))
        rm, rse = np.asarray(ref[key]), np.asarray(ref[key + "_se"])
        z = (m - rm) / np.sqrt(se ** 2 + rse ** 2)
        worst = max(worst, float(np.abs(z).max()))
        log(f"[eam-physics] {key} by slot, port {m.tolist()} (se "
            f"{se.tolist()}); JAX gather {rm.tolist()}; z "
            f"{np.round(z, 2).tolist()}")
    log(f"[eam-physics] sampling: max |z| {worst:.2f} over 3 x "
        f"{len(temp)} slots, {len(seeds)} chains a side (limit {Z_PHYS})")
    check(worst < Z_PHYS, f"[eam-physics] sampling differs from the JAX "
          f"gather chains: max |z| {worst:.2f}")
    tm_p = np.array([classifier_tm(res.g_slot, temp, CLF_SEEDS)
                     for res in runs])
    tm_j = np.array([classifier_tm(c["g_slot"], temp, CLF_SEEDS)
                     for c in ref["chains"]])
    spread = math.sqrt((tm_p.var(ddof=1) + tm_j.var(ddof=1)) / 2.0)
    se = spread * math.sqrt(2.0 / len(seeds))
    diff = float(tm_p.mean() - tm_j.mean())
    dt = time.perf_counter() - t
    log(f"[eam-physics] T_m, the port's classifier (seeds "
        f"{list(CLF_SEEDS)}) by chain: on the port's chains "
        f"{np.round(tm_p, 1).tolist()}, mean {tm_p.mean():.1f} K; on the "
        f"JAX chains {np.round(tm_j, 1).tolist()}, mean {tm_j.mean():.1f} "
        f"K; difference {diff:.1f} K, z {diff / se:.2f} (limit {Z_PHYS})")
    tm_pipe = [round(float(res.tm[0]), 1) for res in runs]
    tm_jax = [c["tm_K"] for c in ref["chains"]]
    log(f"[eam-physics] the pipeline's T_m by chain (classifier seed 0): "
        f"port {tm_pipe}, JAX gather {np.round(tm_jax, 1).tolist()}; chain "
        f"{seeds[0]}: port {tm_pipe[0]} K against the JAX cellmc leg's "
        f"1766.3 K (eam_tm_ab.json clong): {abs(tm_pipe[0] / 1766.3 - 1):.4f};"
        f" {dt:.1f} s on {name}")
    check(abs(diff) < Z_PHYS * se, f"[eam-physics] T_m on the port's chains "
          f"differs from T_m on the JAX chains: {diff:.1f} K, se {se:.1f}")


# ---------------------------------------------------------------------------
# serial path (B5) and the probe (P1)
# ---------------------------------------------------------------------------

def b5_case(r, ncells, m, seed, lattice=1.6, jitter=0.04, step=0.15):
    """R jittered fcc replicas, M distinct movers each, displaced by up to
    +-step per axis: (pos, box, ids, old_r, new_r) on the card."""
    pos, box = make_supercell("fcc", lattice, ncells)
    n = pos.shape[0]
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + jitter * g.standard_normal(pos.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    ids = np.stack([g.choice(n, m, replace=False) for _ in range(r)])
    old = np.take_along_axis(pos, ids[..., None], axis=1)
    new = (old + g.uniform(-step, step, old.shape)).astype(np.float32)
    boxes = np.repeat(np.asarray(box, np.float32)[None], r, 0)
    return tuple(torch.as_tensor(x, device=DEV) for x in
                 (pos, boxes, ids.astype(np.int32), old, new))


def b5_terms(pot, case):
    """Per mover, the summed magnitudes of its e and w terms (both sides),
    and the number of (mover, atom, side) terms inside rc."""
    pos, box, ids, old, new = case
    _, rc2, _, _ = pot.f32_consts()
    col = torch.arange(pos.shape[1], device=DEV)
    notself = col[None, None, :] != ids[:, :, None]
    se = sw = 0.0
    n_in = 0
    for r in (old, new):
        d = min_image(r[:, :, None, :] - pos[:, None, :, :],
                      box[:, None, None, :])
        r2 = (d * d).sum(-1)
        ok = notself & (r2 < rc2)
        e, w = pot.pair_e_w(torch.clamp(r2, min=LD.R2_FLOOR))
        se = se + torch.where(ok, e.abs(), 0.0).sum(-1)
        sw = sw + torch.where(ok, w.abs(), 0.0).sum(-1)
        n_in += int(ok.sum())
    return se, sw, n_in


def compare_b5(pot, case, tag):
    pos, _, ids, _, _ = case
    (r, n, _), m = pos.shape, ids.shape[1]
    dek, dwk = LD.delta_moves(pot, *case)
    dep, dwp = LD.delta_moves_plain(pot, *case)
    torch.cuda.synchronize()
    se, sw, n_in = b5_terms(pot, case)
    for nm, k, p, mag in (("dE", dek, dep, se), ("dW", dwk, dwp, sw)):
        err = (k - p).abs()
        worst = float((err / mag.clamp(min=1e-30)).max())
        log(f"[{tag}] B5 R={r} N={n} M={m} {nm}: max |k - p| "
            f"{float(err.max()):.3e}, max |k - p| / sum|terms| {worst:.3e} "
            f"(limit {B5_RTOL:g}); |{nm}| up to {float(p.abs().max()):.3e}")
        check(bool((err <= B5_RTOL * mag + 1e-6).all()),
              f"[{tag}] B5 {nm} disagrees with its plain version")
        check(bool(torch.isfinite(k).all()), f"[{tag}] B5 {nm} not finite")
    ERR["delta"] = max(ERR["delta"], float((dek - dep).abs().max()))
    return n_in


def b5_bound(r, n, m, n_in):
    nbytes = 4 * (r * n * 3 + r * 3 + r * m + 2 * r * m * 3 + 2 * r * m)
    return bound(nbytes, 2 * r * m * (n - 1) * OPS_B5_PAIR + n_in * OPS_B5_IN)


def phase_serial_small():
    pot = LJCut.create()
    for r, ncells, m, seed in ((1, 4, 4, 0), (2, 3, 2, 1)):
        compare_b5(pot, b5_case(r, ncells, m, seed), "serial-small")


def phase_serial_full(name):
    pot = LJCut.create()
    lat = 2.0 ** (2.0 / 3.0)
    # the serial engine's own launch: one mover of config 1's crystal
    case = b5_case(1, 4, 1, 2, lattice=lat, jitter=0.03, step=0.1)
    n_in = compare_b5(pot, case, "serial-full")
    # a launch this small takes less time on the card than the host needs
    # to issue it: the kernel's own time comes from torch.profiler, the
    # CUDA-event time per call back to back is the issue rate
    ms1 = P1.device_ms(lambda: LD.delta_moves(pot, *case), 200, "delta_")
    ev1 = cuda_ms(lambda: LD.delta_moves(pot, *case), 200)
    pms1 = cuda_ms(lambda: LD.delta_moves_plain(pot, *case), 50)
    TIMES["delta"] = (ms1, pms1)
    BOUND["delta"] = b5_bound(1, 256, 1, n_in)
    # batched: BASELINE config 2's 8x8 grid of 4096-atom LJ, 32 movers each
    big = b5_case(64, (16, 8, 8), 32, 3, lattice=lat, jitter=0.03, step=0.1)
    n_in_big = compare_b5(pot, big, "serial-full")
    ms = P1.device_ms(lambda: LD.delta_moves(pot, *big), 20, "delta_")
    ev = cuda_ms(lambda: LD.delta_moves(pot, *big), 20)
    pms = cuda_ms(lambda: LD.delta_moves_plain(pot, *big), 3)
    bms, by = b5_bound(64, 4096, 32, n_in_big)
    log(f"[serial-full] B5 R=1 N=256 M=1: kernel {ms1:.4f} ms on the "
        f"device ({ev1:.4f} ms per call as issued), plain {pms1:.4f} ms, "
        f"bound {BOUND['delta'][0]:.6f} ms ({BOUND['delta'][1]}); R=64 "
        f"N=4096 M=32: kernel {ms:.4f} ms on the device ({ev:.4f} as "
        f"issued), plain {pms:.4f} ms, bound {bms:.6f} ms ({by}), "
        f"{n_in_big} terms inside rc (after warm-up) on {name}")


def golden_records(recs, frames, nrec, tag):
    """Hold the first nrec records and frames to tests/golden/config1.*."""
    _, want = thermo.read(os.path.join(GOLDEN, "config1.thrm"))
    gpos, gbox, gsweep = traj.read(os.path.join(GOLDEN, "config1.traj"))
    got = {c: getattr(recs, c)[:nrec].cpu().numpy() for c in thermo.COLUMNS}
    for c in ("sweep", "acc_pos", "acc_vol", "dpos", "dvol"):
        w = want[c][:nrec].astype(got[c].dtype)
        check(np.array_equal(got[c], w),
              f"[{tag}] {c} differs from the golden file: {got[c]} vs {w}")
    worst = {}
    for c, rtol, atol in (("pe", 2e-4, 5e-3), ("virial", 2e-4, 5e-3),
                          ("vol", 1e-5, 0.0)):
        d = np.abs(got[c].astype(np.float64) - want[c][:nrec])
        worst[c] = float((d / np.abs(want[c][:nrec])).max())
        check(bool((d <= atol + rtol * np.abs(want[c][:nrec])).all()),
              f"[{tag}] {c} differs from the golden file: {got[c]} vs "
              f"{want[c][:nrec]}")
    dx = float(np.abs(frames[0][:nrec].cpu().numpy() - gpos[:nrec]).max())
    db = float(np.abs(frames[1][:nrec].cpu().numpy() - gbox[:nrec]).max())
    check(max(dx, db) <= 5e-4, f"[{tag}] frames differ: |dx| {dx}, |dbox| "
          f"{db}")
    log(f"[{tag}] records 1-{nrec}: sweep, acc_pos, acc_vol, dpos, dvol "
        f"equal to tests/golden/config1.thrm; max rel err pe "
        f"{worst['pe']:.2e}, virial {worst['virial']:.2e} (limit 2e-4 + "
        f"5e-3 abs), vol {worst['vol']:.2e} (limit 1e-5); frames |dx| "
        f"{dx:.2e}, |dbox| {db:.2e} (limit 5e-4)")


def first_divergence(tr_a, tr_b):
    """(sweep, attempt, margin a, margin b, move type) of the first decision
    that differs between two traced chains of the same key, or None."""
    for s, ((ta, aa, ma), (tb, ab, mb)) in enumerate(zip(tr_a, tr_b)):
        check(torch.equal(ta, tb), f"move types differ in sweep {s}")
        diff = torch.nonzero(aa.cpu() != ab.cpu()).reshape(-1)
        if len(diff):
            a = int(diff[0])
            return s, a, float(ma[a]), float(mb[a]), int(ta[a])
    return None


def phase_golden(name):
    n = 256
    LD.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, recs, frames = GOLD.run_chain()          # the default device
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = LD.LAUNCHES["delta"]
    KERNELS["delta"]["launches"] = launches
    check(recs.pe.device.type == "cuda", "[golden] did not run on the card")
    # every decision against the port's CPU run (tier-1 holds that run to
    # the JAX chain); a traced chain computes each attempt's margin
    tr_k, tr_c = [], []
    _, recs_k, frames_k = GOLD.run_chain(DEV, trace=tr_k)
    GOLD.run_chain("cpu", trace=tr_c)
    nsw = len(tr_k)
    npos = sum(int((mt == 0).sum()) for mt, _, _ in tr_k)
    margin = min(float(m.abs().min()) for _, _, m in tr_k)
    log(f"[golden] config 1: {nsw} sweeps of {n} attempts in {secs:.3f} s, "
        f"{secs / nsw * 1e3:.2f} ms per sweep, {nsw * n / secs:.4e} "
        f"attempted moves/s on {name}; B5 launches {launches}, position "
        f"attempts {npos}; smallest decision margin |ln u - ln w| "
        f"{margin:.3e}")
    check(launches == npos, f"[golden] B5 launched {launches} times for "
          f"{npos} position attempts")
    check(torch.equal(recs.acc_pos, recs_k.acc_pos)
          and torch.equal(recs.acc_vol, recs_k.acc_vol),
          "[golden] the traced run made other decisions")
    nrec = 4
    div = first_divergence(tr_k, tr_c)
    if div is None:
        log("[golden] every decision equals the port's CPU run")
    else:
        s, a, mk, mc, mt = div
        log(f"[golden] first decision that differs from the port's CPU run: "
            f"sweep {s}, attempt {a} (move type {mt}), margin |ln u + "
            f"beta dE| {abs(mk):.3e} on the card, {abs(mc):.3e} on the CPU")
        check(abs(mk) < 1e-4, f"[golden] decision differs at margin "
              f"{abs(mk):.3e} (not a rounding tie)")
        nrec = s // 4                   # config 1: 4 sweeps a record
        log(f"[golden] a rounding tie between two f32 summation orders: "
            f"holding the {nrec} records before sweep {s}")
    if nrec:
        golden_records(recs, frames, nrec, "golden")
    profile_sweep(name)


def profile_sweep(name):
    """One config-1 sweep on the card under torch.profiler, after one
    warm-up sweep: wall, device busy and idle share, kernels per attempt."""
    from torch.profiler import ProfilerActivity, profile
    pot, state, sweep = GOLD.setup_chain(DEV)
    sweep(pot, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sweep(pot, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = kernels = b5 = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = (ev.self_cuda_time_total if t is None else t) / 1e3
        if t <= 0:
            continue
        busy += t
        kernels += ev.count
        if "delta_" in ev.key:
            b5 += t
    n = state.pos.shape[0]
    check(busy > 0, "[golden] the profiler saw no device time")
    log(f"[golden] one sweep under torch.profiler: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms (B5 {b5:.3f} ms), idle share "
        f"{1.0 - busy / wall:.4f}, {kernels / n:.1f} device operations per "
        f"attempt on {name}")


def phase_golden_hmc(name):
    kw = dict(ncells=2, seed=9, temp=0.8, press=1.0, dpos0=0.1,
              dvol_frac0=0.01, dt0=0.005, ppos=0.7, pvol=0.05, nstps=4,
              mass=1.0, mod=1, nrecords=2)
    tr_k = []
    sk, rk, _ = GOLD.run_chain(DEV, trace=tr_k, **kw)
    sc, rc, _ = GOLD.run_chain("cpu", **kw)
    nh = sum(int((mt == 2).sum()) for mt, _, _ in tr_k)
    dx = float((sk.pos.cpu() - sc.pos).abs().max())
    log(f"[golden-hmc] 32 atoms, 2 sweeps, {nh} HMC trials: acc_pos "
        f"{rk.acc_pos.tolist()} / {rc.acc_pos.tolist()}, acc_vol "
        f"{rk.acc_vol.tolist()} / {rc.acc_vol.tolist()}, acc_hmc "
        f"{rk.acc_hmc.tolist()} / {rc.acc_hmc.tolist()} (card / CPU); max "
        f"|dx| {dx:.3e} (limit 1e-2) on {name}")
    check(nh > 0, "[golden-hmc] no HMC trial")
    for c in ("acc_pos", "acc_vol", "acc_hmc"):
        check(torch.equal(getattr(rk, c).cpu(), getattr(rc, c)),
              f"[golden-hmc] {c} differs between the card and the CPU")
    check(dx <= 1e-2, f"[golden-hmc] positions differ by {dx}")


def phase_probe(name):
    a, b = P1.inputs(DEV)
    errs = {}
    for v in P1.VARIANTS:
        dt = P1.dtype_of(v)
        av, bv = a.to(dt), b.to(dt)
        k, p = P1.probe(v, av, bv), P1.probe_plain(v, av, bv)
        torch.cuda.synchronize()
        errs[v] = float((k - p).abs().max())
        rel = errs[v] / float(p.abs().max())
        check(bool(torch.isfinite(k).all()) and rel <= PROBE_TOL.get(v, 1e-6),
              f"[probe] {v}: rel err {rel:.3e} against the plain version")
    ERR["probe"] = errs["pair_div"]
    log("[probe] max |kernel - plain| by variant: "
        + ", ".join(f"{v} {e:.2e}" for v, e in errs.items())
        + " (limit, relative to max |plain|: 1e-6; 1e-4 for rcp.approx and "
        "rsqrtf; 2^-5 for bf16)")
    plain_ms = cuda_ms(lambda: P1.probe_plain("pair_div", a, b), 2)
    P1.reset_launches()
    res = P1.measure(DEV)
    KERNELS["probe"]["launches"] = P1.LAUNCHES["probe"]
    TIMES["probe"] = (res["pair_div"]["ms"], plain_ms)
    pairs = P1.ROWS * P1.LANES * P1.REPS
    BOUND["probe"] = bound(4 * 3 * P1.ROWS * P1.LANES,
                           P1.OPS["pair_div"] * pairs)
    for v, r in res.items():
        log(f"[probe] {v:14s} {r['ms']:.4f} ms per launch on the device "
            f"({r['event_ms']:.4f} ms as issued, {r['launches']} launches), "
            f"{r['ns_per_pair']:.5f} ns per pair, "
            f"{r['ops_per_pair']} f32 ops per pair, "
            f"{100 * r['share_f32_peak']:.2f}% of 67 TFLOP/s on {name}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    log(f"[card] {name}; torch.cuda.get_device_name(0)="
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    table = eam_table()
    phases = (("build", phase_build), ("small", phase_small),
              ("full", lambda: phase_full(name)),
              ("main", lambda: phase_main(name)),
              ("physics", lambda: phase_physics(name)),
              ("eam-small", lambda: phase_eam_small(table)),
              ("eam-full", lambda: phase_eam_full(name, table)),
              ("eam-main", lambda: phase_eam_main(name, table)),
              ("eam-physics", lambda: phase_eam_physics(name, table)),
              ("serial-small", phase_serial_small),
              ("serial-full", lambda: phase_serial_full(name)),
              ("golden", lambda: phase_golden(name)),
              ("golden-hmc", lambda: phase_golden_hmc(name)),
              ("probe", lambda: phase_probe(name)))
    for ph, fn in phases:
        t = time.perf_counter()
        fn()
        log(f"[{ph}] done in {time.perf_counter() - t:.1f} s")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "neuralmelting_tpu"))
    check(not foreign, f"jax or the JAX package was imported: {foreign}")
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    kern = []
    for k, meta in KERNELS.items():
        ms, pms = TIMES[k]
        bms, by = BOUND[k]
        # no single PyTorch call computes a cell-list pair sum, a
        # Metropolis sweep, a brute-force dE sum or the probe's loop: there
        # is no library yardstick
        kern.append(dict(meta, max_abs_err=ERR[k], ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, library_ms=None))
    print(name)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
