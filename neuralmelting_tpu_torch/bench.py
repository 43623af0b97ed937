"""Benchmark of the port: attempted MC moves/s on the card, three rows.

    python -m neuralmelting_tpu_torch.bench [--device cuda] [--sweep]

- **LJ kernel row**: the north-star configuration (fcc 16x8x8 = 4096
  atoms, a 32x32 (P, T) grid over P* in [1, 8] and T* in [0.7, 1.3],
  R = 1024, seed 1234, dpos0 0.11, dvol0 0.002) in chunks of 20 sweeps:
  one volume trial every 4th sweep, a grid-shift rebin every 2nd,
  tempering on, step adaptation off (the acceptance counters accumulate),
  no frames. Two warm-up chunks, each followed by the runner's geometry
  maintenance so the slot capacity settles, then three chunks timed
  between two device syncs. Rate: attempted position and volume moves
  (the ``ntp`` and ``ntv`` differences) per second.
- **LJ end-to-end row**: from there, one production chunk of
  ``runner.run_sampling`` (10 records, adaptation, records, geometry
  maintenance, no files), then a second one timed. Rate: sweeps x atoms
  per second.
- **EAM row**: 4096 Al atoms on a 16x16 grid (P in [1, 5000] bar, T in
  [600, 1400] K, seed 11, dpos0 0.15, dvol0 0.002) with the rc = 3.8
  synthetic table (``models/eam_gen.py``, written to a temporary
  directory), the kernel row's protocol.
- **EAM melting sweep** (``--sweep``; ``scripts/eambench.py``'s
  points/hour half): docs/VALIDATION.md config 3 (256 Al atoms, 1 bar,
  10 temperatures 400-2200 K, 30 records of 15 sweeps, 6 cut, seed 5)
  through ``pipeline.melting_pipeline`` with the same table, timed:
  (P, T) points/hour and T_m.

Prints one JSON line of scalars: each row's rate, diag (0 when clean),
seconds, slot capacity, atoms and replicas, the device, and the card's
name and power limit from nvidia-smi. Runs on the card unless given
``--device cpu``; without a GPU the default raises. ``measure`` and
``report`` take the configurations and the device, so a test runs them at
a tiny size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.pipeline import melting_pipeline
from neuralmelting_tpu_torch.profile_chunk import configs as full_configs
from neuralmelting_tpu_torch.sampler import cellmc as SC

SWEEPS_PER_CHUNK = 20
WARM_CHUNKS = 2
TIMED_CHUNKS = 3
E2E_RECORDS = 10


def configs():
    """The bench's LJ and EAM configurations: profile_chunk's full-width
    ones with one record of 20 sweeps a chunk."""
    full = full_configs()
    return {k: dataclasses.replace(full[k], name=name, nsmpl=1,
                                   mod=SWEEPS_PER_CHUNK)
            for k, name in (("lj", "bench"), ("eam", "eambench"))}


def kernel_row(setup):
    """Kernel-row protocol on ``setup``: (setup after the timed chunks,
    attempted moves a second, seconds a chunk, diag of every chunk)."""
    cfg, dev = setup.cfg, setup.device
    diag = 0

    def chunk(setup):
        make = (SC.make_eam_run_fn if setup.style == "eam"
                else SC.make_cellmc_run_fn)
        run = make(setup.us.kb, setup.us.p2e, setup.geom, mod=cfg.mod,
                   nrecords=1, ncyc=SC.default_ncyc(setup.geom), nvol=1,
                   vol_every=4, rebin_every=2, exchange=True,
                   npress=len(setup.press), ntemp=len(setup.temp),
                   adapt=False, write_traj=False)
        (states, slabs, count, shift, slot_of, _recs, _frames, _hist,
         _xacc, d, tried) = run(
            setup.states, setup.slabs, setup.slab_count, setup.shift,
            setup.slot_of, jrandom.key(cfg.seed + 1), setup.pot,
            setup.cell_tabs, setup.t_grid, setup.p_grid,
            (cfg.seed, cfg.seed + 7))
        return dataclasses.replace(
            setup, states=states, slabs=slabs, slab_count=count,
            shift=shift, slot_of=slot_of,
            moves_tried=setup.moves_tried + tried), d

    for _ in range(WARM_CHUNKS):
        setup, d = chunk(setup)
        diag |= int(d)
        setup = runner._refresh_cellmc_geom(setup)
    ntp0, ntv0 = setup.states.ntp.clone(), setup.states.ntv.clone()
    t1 = runner.timed(dev)
    ds = []
    for _ in range(TIMED_CHUNKS):
        setup, d = chunk(setup)
        ds.append(d)
    t2 = runner.timed(dev)
    for d in ds:
        diag |= int(d)
    moves = int((setup.states.ntp - ntp0).sum()
                + (setup.states.ntv - ntv0).sum())
    return setup, moves / (t2 - t1), (t2 - t1) / TIMED_CHUNKS, diag


def e2e_row(setup):
    """(setup, sweeps x atoms a second, seconds, diag) of the second of
    two ``run_sampling`` chunks of E2E_RECORDS records."""
    setup = runner.run_sampling(setup, write_files=False, write_traj=False,
                                nrecords=E2E_RECORDS)[0]
    sweep0 = setup.states.sweep.clone()
    t1 = runner.timed(setup.device)
    setup, *_, diag = runner.run_sampling(
        setup, write_files=False, write_traj=False, nrecords=E2E_RECORDS)
    t2 = runner.timed(setup.device)
    sweeps = int((setup.states.sweep - sweep0).sum())
    return setup, sweeps * setup.natoms / (t2 - t1), t2 - t1, diag


def melting_sweep(device, fast: bool = False) -> dict:
    """Config 3's melting sweep through ``melting_pipeline`` on the cellmc
    EAM engine, timed from set-up to T_m (``fast``: 4 temperatures, 4
    records, 1 cut). Returns the ``sweep_*`` keys of the bench's row."""
    dev = runner.resolve_device(device)
    nt = 4 if fast else 10
    cfg = RunConfig(
        name="eamsweep", element="AL", ncells=(4, 4, 4),   # 256 atoms
        npress=1, ntemp=nt, press=(1.0,),
        temp=tuple(float(t) for t in np.linspace(400.0, 2200.0, nt)),
        nsmpl=4 if fast else 30, mod=15, ncut=1 if fast else 6,
        seed=5, dpos0=0.15, dvol0=0.01)
    with tempfile.TemporaryDirectory(prefix="nm_sweep_") as tmp:
        table = os.path.join(tmp, "al38.eam.alloy")
        eam_gen.write_setfl(table, rc=3.8)
        t0 = runner.timed(dev)
        res = melting_pipeline(cfg, setfl=table, engine="cellmc", nbins=48,
                               device=dev)
        dt = runner.timed(dev) - t0
    return {
        "sweep_tm_K": float(res.tm[0]),
        "sweep_tm_gather_engine_K": 1778.2,   # eam_tm_ab.json glong leg
        "sweep_points": nt,
        "sweep_seconds": round(dt, 1),
        "sweep_points_per_hour": nt / (dt / 3600.0),
        "sweep_diag": res.diag,
        "sweep_probs": [round(float(p), 3) for p in res.probs[0]],
    }


def card_info():
    """(name, power limit in W) from nvidia-smi, or (None, None)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None, None
    if out.returncode != 0 or not out.stdout.strip():
        return None, None
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit)


def measure(cfgs, device) -> dict:
    """The bench's JSON row for the configurations ``cfgs`` ({"lj": ...,
    "eam": ...}) on ``device``."""
    dev = runner.resolve_device(device)
    row = {}
    setup = runner.setup_run(cfgs["lj"], engine="cellmc", device=dev)
    setup, rate, sec, diag = kernel_row(setup)
    row.update(lj_kernel_moves_per_sec=rate, lj_kernel_sec_per_chunk=sec,
               lj_kernel_diag=diag, lj_kcap=setup.geom.kcap)
    setup, rate, sec, diag = e2e_row(setup)
    row.update(lj_e2e_moves_per_sec=rate, lj_e2e_sec_per_chunk=sec,
               lj_e2e_diag=diag, lj_natoms=setup.natoms,
               lj_replicas=int(setup.states.temp.shape[0]))
    del setup                   # the LJ ensemble leaves the card first
    with tempfile.TemporaryDirectory(prefix="nm_bench_") as tmp:
        table = os.path.join(tmp, "al38.eam.alloy")
        eam_gen.write_setfl(table, rc=3.8)
        setup = runner.setup_run(cfgs["eam"], setfl=table, engine="cellmc",
                                 device=dev)
    setup, rate, sec, diag = kernel_row(setup)
    row.update(eam_moves_per_sec=rate, eam_sec_per_chunk=sec, eam_diag=diag,
               eam_kcap=setup.geom.kcap, eam_natoms=setup.natoms,
               eam_replicas=int(setup.states.temp.shape[0]))
    name, limit = card_info() if dev.type == "cuda" else (None, None)
    row.update(sweeps_per_chunk=cfgs["lj"].mod,
               device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
               gpu_name=name, power_limit_w=limit)
    return row


def report(cfgs, device, sweep: bool = False) -> dict:
    """``measure`` (and with ``sweep`` the melting sweep's keys), printed
    as one compact JSON line; returns the row."""
    row = measure(cfgs, device)
    if sweep:
        row.update(melting_sweep(device))
    print(json.dumps(row, separators=(",", ":")), flush=True)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--sweep", action="store_true",
                    help="add the EAM melting sweep's points/hour")
    args = ap.parse_args(argv)
    return report(configs(), args.device, args.sweep)


if __name__ == "__main__":
    main()
