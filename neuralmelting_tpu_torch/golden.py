"""BASELINE config 1 through the port's serial engine: the golden files.

    python -m neuralmelting_tpu_torch.golden [outdir] [--device cpu]

Counterpart of ``tests/make_golden.py``: LJ NPT Metropolis MC, 256 atoms
(4x4x4 fcc cells of edge 2^(2/3), rho* = 1), one (P, T) point,
T* = 0.8, P* = 2.0, seed 256, 4 records of mod = 4 sweeps, position and
volume moves (ppos 0.96875, pvol 0.03125), the brute-force backend (kernel
B5 on the card). Writes ``config1.thrm`` and ``config1.traj`` to outdir
(default: the current directory). Runs on the card unless asked for the
CPU; without a GPU the default raises. The JAX package's files of the
same run are committed as ``tests/golden/config1.*``.
"""

from __future__ import annotations

import argparse
import os

import torch

from neuralmelting_tpu_torch.io import thermo, traj
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler import driver, moves, serial
from neuralmelting_tpu_torch.sampler.state import init_state

PARAMS = {"element": "LJ", "natoms": 256,
          "config": "baseline-config1 seed=256"}


def run_chain(device="cuda", ncells=4, seed=256, temp=0.8, press=2.0,
              dpos0=0.125, dvol_frac0=0.015625, dt0=0.005, ppos=0.96875,
              pvol=0.03125, nstps=16, mass=1.0, mod=4, nrecords=4,
              trace=None):
    """(state, records, frames) of one serial LJ chain from an fcc crystal
    of ncells^3 cells at rho* = 1 with the brute-force backend; the
    defaults are config 1. ``trace`` as in ``serial.make_sweep_fn``."""
    pot, state, sweep = setup_chain(device, ncells, seed, temp, press,
                                    dpos0, dvol_frac0, dt0, ppos, pvol,
                                    nstps, mass, trace)
    run = driver.make_run_fn(sweep, kb=1.0, mod=mod, nrecords=nrecords)
    return run(pot, state)


def setup_chain(device="cuda", ncells=4, seed=256, temp=0.8, press=2.0,
                dpos0=0.125, dvol_frac0=0.015625, dt0=0.005, ppos=0.96875,
                pvol=0.03125, nstps=16, mass=1.0, trace=None):
    """(pot, state, sweep_fn) of ``run_chain``'s chain before its first
    sweep."""
    pot = LJCut.create()
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), ncells)
    state = init_state(pot, pos, box, jrandom.key(seed), temp, press,
                       dpos0, dvol_frac0, dt0, device=device)
    sweep = serial.make_sweep_fn(1.0, 1.0, moves.brute_backend(), ppos,
                                 pvol, nstps, mass, trace=trace)
    return pot, state, sweep


def write_files(outdir, recs, frames):
    os.makedirs(outdir, exist_ok=True)
    rows = {c: getattr(recs, c) for c in thermo.COLUMNS}
    thermo.write(os.path.join(outdir, "config1.thrm"), rows, params=PARAMS)
    traj.write(os.path.join(outdir, "config1.traj"), frames[0], frames[1],
               sweeps=recs.sweep)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, recs, frames = run_chain(torch.device(args.device))
    write_files(args.outdir, recs, frames)
    print(f"golden files written to {args.outdir}")


if __name__ == "__main__":
    main()
