"""Shared CLI plumbing for the five pipeline stages (counterpart of
``neuralmelting_tpu.cli.common``, plus ``--device``)."""

from __future__ import annotations

import argparse

import numpy as np

from neuralmelting_tpu_torch.config import RunConfig


def add_run_args(ap: argparse.ArgumentParser):
    """Reference-style sampler flags (lammps_remcmc.py CLI)."""
    ap.add_argument("-n", "--name", default="remcmc")
    ap.add_argument("-e", "--element", default="LJ", choices=("LJ", "AL"))
    ap.add_argument("-ss", "--supercell-size", type=int, nargs="+",
                    default=[4], help="conventional cells per axis (1 or 3 ints)")
    ap.add_argument("-pn", "--pressure-number", type=int, default=4)
    ap.add_argument("-pr", "--pressure-range", type=float, nargs=2,
                    default=None)
    ap.add_argument("-tn", "--temperature-number", type=int, default=16)
    ap.add_argument("-tr", "--temperature-range", type=float, nargs=2,
                    default=None)
    ap.add_argument("-sc", "--sample-cutoff", type=int, default=16,
                    help="burn-in records discarded downstream")
    ap.add_argument("-sn", "--sample-number", type=int, default=64,
                    help="recorded samples per (P,T) point")
    ap.add_argument("-sm", "--sample-mod", type=int, default=32,
                    help="sweeps between records/adaptations")
    ap.add_argument("-pp", "--position-probability", type=float,
                    default=0.96875)
    ap.add_argument("-vp", "--volume-probability", type=float,
                    default=0.03125)
    ap.add_argument("-hp", "--hmc-probability", "--phmc", type=float,
                    default=0.0, help="> 0: one HMC move a sweep (gather "
                                      "engine only)")
    ap.add_argument("-ns", "--nstps", type=int, default=16,
                    help="HMC leapfrog steps")
    ap.add_argument("-sd", "--seed", type=int, default=256)
    ap.add_argument("--setfl", default=None,
                    help="setfl table for EAM elements")
    ap.add_argument("--skin", type=float, default=0.4)
    ap.add_argument("--dpos0", type=float, default=0.125)
    ap.add_argument("--dvol0", type=float, default=0.015625)
    add_device_arg(ap)


def add_device_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")


def config_from_args(args) -> RunConfig:
    ss = args.supercell_size
    ncells = tuple(ss * 3) if len(ss) == 1 else tuple(ss)
    t_range = tuple(args.temperature_range) if args.temperature_range else None
    p_range = tuple(args.pressure_range) if args.pressure_range else None
    temp = (tuple(np.linspace(*t_range, args.temperature_number))
            if t_range else None)
    press = (tuple(np.linspace(*p_range, args.pressure_number))
             if p_range else None)
    return RunConfig(
        name=args.name, element=args.element, ncells=ncells,
        npress=args.pressure_number, ntemp=args.temperature_number,
        press=press, temp=temp,
        ppos=args.position_probability, pvol=args.volume_probability,
        phmc=args.hmc_probability, nsmpl=args.sample_number,
        mod=args.sample_mod, ncut=args.sample_cutoff, nstps=args.nstps,
        seed=args.seed, dpos0=args.dpos0, dvol0=args.dvol0, skin=args.skin)
