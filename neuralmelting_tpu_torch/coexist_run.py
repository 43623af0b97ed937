"""Two-phase coexistence T_m bracket (counterpart of
``scripts/coexist_run.py``; the method is in ``coexist.py``).

    python -m neuralmelting_tpu_torch.coexist_run [--element LJ|AL]
        [--fast] [--chunks N] [--relax N] [--temps lo:hi:n]
        [--device cuda|cpu] [--out PATH]

A liquid is prepared in a half-sized box, spliced against a half
lattice, and a 3-row ensemble (pure solid, pure liquid, two-phase; one
pressure, tempering off) is sampled at every temperature of the grid.
After ``--relax`` chunks, each of ``--chunks`` measured chunks adds the
rows' PE/atom to a series; the run stops early once the tail bracket is
consistent and at most two temperatures stay unresolved (from the tenth
measured chunk on). The classification of the tail gives the bracket
[max frozen T, min melted T].

LJ: 16x8x8 fcc cells (4096 atoms), prepared at 8x8x8, T* 0.70-0.82 in 13
steps at P* = 1. AL: the same cells with the rc = 3.8 synthetic table
(``models/eam_gen.py``, written to a temporary directory), 1700-1820 K.
``--fast``: 8x4x4 cells prepared at 4x4x4, 1 relax + 2 measured chunks
of 2 records. Runs on the card unless given ``--device cpu``; without a
GPU the default raises. Writes the result JSON to ``--out``, by default
``output/coexist_result_torch[_al][_fast].json``, and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from neuralmelting_tpu_torch import coexist, runner
from neuralmelting_tpu_torch.models import eam_gen


def parse_temps(spec):
    lo, hi, n = spec.split(":")
    return np.linspace(float(lo), float(hi), int(n))


def make_params(element: str, fast: bool, chunks=None, relax=None,
                temps=None) -> dict:
    """The run's parameters, as ``scripts/coexist_run.py`` sets them.
    The EAM table path is left to the caller (``setfl`` None)."""
    if element == "LJ":
        # anchor: T*(P*=1) = 0.780, heating edge 0.794; the grid top sits
        # just above the heating edge
        p = dict(element="LJ", temps=parse_temps(temps or "0.70:0.82:13"),
                 temp_melt=2.2, temp_hold=0.80, gap=0.5)
    else:
        # straddles the heating/cooling bracket [1763.8, 1766.3] K
        # (eam_tm_ab.json); temp_hold 1100 K is the reference's (C4)
        p = dict(element="AL", temps=parse_temps(temps or "1700:1820:13"),
                 temp_melt=2600.0, temp_hold=1100.0, gap=1.2)
    p.update(setfl=None, press=1.0,
             ncells=(8, 4, 4) if fast else (16, 8, 8),
             prep_cells=(4, 4, 4) if fast else (8, 8, 8), mod=20,
             chunks=int(chunks) if chunks is not None else (2 if fast
                                                              else 40),
             relax=int(relax) if relax is not None else (1 if fast else 3),
             records=2 if fast else 5,
             melt_records=2 if fast else 5, hold_records=1 if fast else 3)
    return p


def run(p: dict, device) -> dict:
    """Prep, build and sample the coexistence ensemble of ``p`` on
    ``device``; returns the result dict (the JAX script's keys)."""
    dev = runner.resolve_device(device)
    temps = p["temps"]
    ntemp = len(temps)
    t_all0 = runner.timed(dev)

    t0 = runner.timed(dev)
    liq_pos, liq_box = coexist.prep_liquid(
        p["element"], p["prep_cells"], temp_melt=p["temp_melt"],
        temp_hold=p["temp_hold"], press=p["press"], mod=p["mod"],
        melt_records=p["melt_records"], hold_records=p["hold_records"],
        setfl=p["setfl"], device=dev)
    prep_secs = runner.timed(dev) - t0
    print(f"prep: liquid box {np.round(liq_box, 3).tolist()} "
          f"in {prep_secs:.1f}s", file=sys.stderr)

    t0 = runner.timed(dev)
    setup = coexist.build_coexist_setup(
        p["element"], p["ncells"], temps, press=p["press"],
        liquid_pos=liq_pos, liquid_box=liq_box, mod=p["mod"],
        gap=p["gap"], setfl=p["setfl"], device=dev)
    build_secs = runner.timed(dev) - t0

    diag_any = 0
    series = []            # per-chunk (NROWS, ntemp) pe/atom
    sweeps_per_chunk = p["records"] * p["mod"]
    t0 = runner.timed(dev)
    for i in range(p["relax"] + p["chunks"]):
        tc = time.perf_counter()
        setup, recs, frames, hist, xacc, diag = runner.run_sampling(
            setup, write_files=False, write_traj=False,
            nrecords=p["records"], exchange=False)
        runner.timed(dev)
        diag_any |= int(diag)
        if int(xacc.sum()) != 0:
            raise RuntimeError(f"chunk {i}: a tempering swap was accepted "
                               "with exchange off")
        rows = coexist.row_pe_per_atom(
            recs.pe.cpu().numpy(), hist.cpu().numpy(), setup.natoms, ntemp)
        phase = "relax" if i < p["relax"] else "meas"
        if phase == "meas":
            series.append(rows)
        x = coexist.liquid_fraction(rows)
        print(f"{phase} chunk {i}: {time.perf_counter() - tc:.1f}s "
              f"diag={int(diag)} x={np.round(x, 2).tolist()}",
              file=sys.stderr)
        # stop once the tail bracket is tight and stable: the unresolved
        # window is the coexistence region itself
        if phase == "meas" and len(series) >= 10:
            res = coexist.classify_series(temps, np.asarray(series))
            lo, hi = res["bracket"]
            if (res["consistent"] and lo is not None and hi is not None
                    and len(res["unresolved_temps"]) <= 2):
                print(f"early stop after {len(series)} chunks: "
                      f"bracket [{lo:.4g}, {hi:.4g}]", file=sys.stderr)
                break
    sample_secs = runner.timed(dev) - t0

    res = coexist.classify_series(temps, np.asarray(series))
    tail_n = res["tail_chunks"]
    tail = np.mean(series[-tail_n:], axis=0)
    return {
        "element": p["element"], "press": p["press"],
        "natoms": setup.natoms, "ntemp": ntemp,
        "temps": [float(t) for t in temps],
        "sweeps_per_chunk": sweeps_per_chunk,
        "relax_chunks": p["relax"], "measured_chunks": len(series),
        "tail_chunks": tail_n,
        "diag": diag_any,
        "prep_seconds": round(prep_secs, 1),
        "build_seconds": round(build_secs, 1),
        "sample_seconds": round(sample_secs, 1),
        "total_seconds": round(runner.timed(dev) - t_all0, 1),
        "pe_rows_tail": tail.tolist(),
        "liquid_fraction_series": [coexist.liquid_fraction(s).tolist()
                                   for s in series],
        "result": res,
        "tm_bracket": res["bracket"],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def default_out(element: str, fast: bool) -> str:
    name = "coexist_result_torch"
    if element == "AL":
        name += "_al"
    if fast:
        name += "_fast"
    return os.path.join("output", name + ".json")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--element", default="LJ", type=str.upper,
                    choices=("LJ", "AL"))
    ap.add_argument("--fast", action="store_true",
                    help="8x4x4 cells, 1 relax + 2 measured chunks")
    ap.add_argument("--chunks", type=int, default=None,
                    help="measured chunks (default 40; 2 with --fast)")
    ap.add_argument("--relax", type=int, default=None,
                    help="relaxation chunks (default 3; 1 with --fast)")
    ap.add_argument("--temps", default=None, help="lo:hi:n temperature grid")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=None, help="result JSON path "
                    "(default output/coexist_result_torch[_al][_fast].json)")
    args = ap.parse_args(argv)
    p = make_params(args.element, args.fast, args.chunks, args.relax,
                    args.temps)
    with tempfile.TemporaryDirectory(prefix="nm_coexist_") as tmp:
        if p["element"] == "AL":
            p["setfl"] = os.path.join(tmp, "al38.eam.alloy")
            eam_gen.write_setfl(p["setfl"], rc=3.8)
        out = run(p, args.device)
    print(json.dumps({"tm_bracket": out["tm_bracket"],
                      "consistent": out["result"]["consistent"],
                      "unresolved": out["result"]["unresolved_temps"],
                      "diag": out["diag"]}, indent=1))
    path = args.out or default_out(p["element"], args.fast)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
