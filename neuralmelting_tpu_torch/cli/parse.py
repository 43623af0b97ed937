"""Stage 2 — parse text outputs into consolidated arrays
(reference: lammps_parse.py; SURVEY.md §2.5, §3.2); the port's copy of
``neuralmelting_tpu.cli.parse``, numpy only.

    python -m neuralmelting_tpu_torch.cli.parse -i out/ -n remcmc -e LJ
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np

from neuralmelting_tpu_torch.io import thermo, traj


def parse_dir(indir: str, prefix: str):
    """Collect all slots matching <prefix>.PP.TT.{thrm,traj}."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.(\d+)\.thrm$")
    slots = {}
    for path in sorted(glob.glob(os.path.join(indir, prefix + ".*.thrm"))):
        m = pat.search(path)
        if not m:
            continue
        p_idx, t_idx = int(m.group(1)), int(m.group(2))
        params, data = thermo.read(path)
        entry = {"thermo": data, "params": params}
        jpath = path[:-5] + ".traj"
        if os.path.exists(jpath):
            pos, boxes, sweeps = traj.read(jpath)
            entry["positions"] = pos
            entry["boxes"] = boxes
        slots[(p_idx, t_idx)] = entry
    return slots


def consolidate(slots):
    """Stack per-slot arrays into (npress, ntemp, ...) grids."""
    ps = sorted({p for p, _ in slots})
    ts = sorted({t for _, t in slots})
    out = {"press_idx": np.asarray(ps), "temp_idx": np.asarray(ts)}
    cols = {}
    for c in thermo.COLUMNS:
        cols[c] = np.stack([
            np.stack([slots[(p, t)]["thermo"][c] for t in ts]) for p in ps])
    out.update(cols)
    if "positions" in next(iter(slots.values())):
        out["positions"] = np.stack([
            np.stack([slots[(p, t)]["positions"] for t in ts]) for p in ps])
        out["boxes"] = np.stack([
            np.stack([slots[(p, t)]["boxes"] for t in ts]) for p in ps])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--indir", default="output")
    ap.add_argument("-n", "--name", default="remcmc")
    ap.add_argument("-e", "--element", default="LJ")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    hits = glob.glob(os.path.join(args.indir,
                                  f"{args.name}.{args.element.lower()}.*.thrm"))
    if not hits:
        raise SystemExit(f"no .thrm files for {args.name}.{args.element.lower()} in {args.indir}")
    base = os.path.basename(hits[0])
    prefix = ".".join(base.split(".")[:-3])
    slots = parse_dir(args.indir, prefix)
    data = consolidate(slots)
    out = args.out or os.path.join(args.indir, prefix + ".parsed.npz")
    np.savez_compressed(out, **data)
    print(f"parsed {len(slots)} samples -> {out}")


if __name__ == "__main__":
    main()
