"""Long-rc EAM run record (counterpart of ``scripts/longrc_run.py``).

    python -m neuralmelting_tpu_torch.longrc_run [--fast] [--out PATH]
        [--device cuda|cpu]

Writes the synthetic Al table at the published tables' cutoff range (rc
6.3 A, rs 5.1 A, Al99.eam.alloy-like) into a temporary directory and runs
the cellmc EAM engine (kernels B3 and B4) on a 7^3 fcc supercell (1372
atoms, the smallest box where the minimum image holds comfortably at
this rc: stride-3 cells (3, 3, 3), one cell a colour, K 72) for a few
NPT chunks: 8 temperatures in 400-1800 K at 1 bar, 3 chunks of 1 record
x 10 sweeps (``--fast``: 2 temperatures, 1 chunk of 2 sweeps), seed 9.

Prints the JSON record: geometry, kcap, the pe/N trace, attempted moves/s
over the chunks (from ``RunSetup.moves_tried``), diag. Writes it to
``--out`` only where given. Runs on the card unless given ``--device
cpu``; without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models import eam_gen

RC, RS = 6.3, 5.1
NCELLS = (7, 7, 7)


def make_cfg(fast: bool = False) -> RunConfig:
    """``scripts/longrc_run.py``'s configuration."""
    nt = 2 if fast else 8
    return RunConfig(
        name="longrc", element="AL", ncells=NCELLS, npress=1, ntemp=nt,
        press=(1.0,),
        temp=tuple(float(t) for t in np.linspace(400.0, 1800.0, nt)),
        nsmpl=1, mod=2 if fast else 10, seed=9, dpos0=0.12, dvol0=0.004)


def write_table(directory: str) -> str:
    path = os.path.join(directory, "longrc_Al.eam.alloy")
    eam_gen.write_setfl(path, rc=RC, rs=RS)
    return path


def run(fast: bool = False, device="cuda", setfl=None) -> dict:
    """The record of ``scripts/longrc_run.py`` on the port's cellmc
    engine; ``setfl`` defaults to the rc 6.3 table in a temp directory."""
    dev = runner.resolve_device(device)
    if setfl is None:
        with tempfile.TemporaryDirectory(prefix="nm_longrc_") as d:
            return run(fast, dev, write_table(d))
    cfg = make_cfg(fast)
    setup = runner.setup_run(cfg, setfl=setfl, engine="cellmc", device=dev)
    pe0 = float(torch.mean(setup.states.pe)) / setup.natoms
    tried0 = int(setup.moves_tried)
    nchunks = 1 if fast else 3
    diag_any, pe_trace, kcaps = 0, [], []
    t0 = runner.timed(dev)
    for _ in range(nchunks):
        setup, recs, _, _, _, diag = runner.run_sampling(
            setup, write_files=False, write_traj=False)
        diag_any |= int(diag)
        kcaps.append(setup.geom.kcap)
        pe_trace.append(round(float(torch.mean(recs.pe[-1]))
                              / setup.natoms, 4))
    dt = runner.timed(dev) - t0
    attempted = int(setup.moves_tried) - tried0
    return {
        "setfl_rc": RC, "ncells": list(NCELLS), "natoms": setup.natoms,
        "replicas": len(cfg.temp),
        "geom_ncell": list(setup.geom.ncell), "kcap": setup.geom.kcap,
        "kcap_by_chunk": kcaps,
        "pe_per_atom_initial": round(pe0, 4),
        "pe_per_atom_trace": pe_trace,
        "diag": diag_any,
        "moves_attempted": attempted,
        "moves_per_sec": attempted / dt,
        "seconds": round(dt, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="2 temperatures, 1 chunk of 2 sweeps")
    ap.add_argument("--out", default=None,
                    help="write the JSON record here (default: print only)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run(fast=args.fast, device=args.device)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
