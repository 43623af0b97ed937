"""Stage 3 — structural features from parsed trajectories (reference:
lammps_rdf.py; counterpart of ``neuralmelting_tpu.cli.rdf``, the same npz
keys), computed on ``--device`` (default: the card).

    python -m neuralmelting_tpu_torch.cli.rdf -i out/remcmc.lj.fcc.4x4x4.parsed.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from neuralmelting_tpu_torch.cli.common import add_device_arg
from neuralmelting_tpu_torch.features.rdf import (density, rdf_frames,
                                                  structure_factor)
from neuralmelting_tpu_torch.runner import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True, help="parsed .npz")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--nbins", type=int, default=64)
    ap.add_argument("--cut", type=int, default=0,
                    help="burn-in records to discard")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    z = np.load(args.input)
    pos = z["positions"]        # (npress, ntemp, nrec, N, 3)
    boxes = z["boxes"]          # (npress, ntemp, nrec, 3)
    npress, ntemp, nrec, natoms, _ = pos.shape
    cut = min(args.cut, nrec - 1)
    pos = pos[:, :, cut:]
    boxes = boxes[:, :, cut:]
    rmax = 0.48 * float(boxes.min())

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    g = rdf_frames(f32(pos.reshape(-1, natoms, 3)), f32(boxes.reshape(-1, 3)),
                   args.nbins, rmax).cpu().numpy()
    g = g.reshape(npress, ntemp, -1, args.nbins)
    g_mean = g.mean(axis=2)                                  # (np, nt, nbins)
    q, sq = structure_factor(f32(g_mean.reshape(-1, args.nbins)),
                             f32(boxes.mean(axis=2).reshape(-1, 3)),
                             natoms, rmax)
    rho = density(f32(boxes), natoms).cpu().numpy().mean(axis=2)

    out = args.out or args.input.replace(".parsed.npz", ".rdf.npz")
    np.savez_compressed(out, g=g, g_mean=g_mean,
                        sq=sq.cpu().numpy().reshape(npress, ntemp, -1),
                        q=q.cpu().numpy(), rho=rho, rmax=rmax,
                        temp=z["temp"][:, :, 0] if "temp" in z else None,
                        press=z["press"][:, :, 0] if "press" in z else None)
    print(f"features -> {out} (g {g.shape}, rmax={rmax:.3f})")


if __name__ == "__main__":
    main()
