#!/usr/bin/env python
"""JAX reference for the PyTorch port's coexistence relaxation check.

    JAX_PLATFORMS=cpu python tests/make_coexist_reference.py [OUT.json]

Runs the LJ coexistence method at ``scripts/coexist_run.py --fast`` size
through the JAX package on the CPU, as independent chains of seeds 31-34
(one process each, four at a time): ``prep_liquid`` at 4x4x4 fcc cells
(melt at T* 2.2, hold at 0.80, P* 1, mod 20, 2 + 1 records), then
``build_coexist_setup`` at 8x4x4 cells (512 atoms) over T* (0.70, 0.76,
0.82), the full run's grid, and three relaxation chunks of 2 records x
20 sweeps with exchange off. Writes, per chain, the prepared liquid's
number density and PE/atom, and each chunk's (solid, liquid, two-phase)
rows of PE/atom, to tests/golden/coexist_relax_jax.json (or OUT.json).

tests/test_torch_coexist_relax.py holds the port's chain of the same
schedule to these chains.
"""

import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHAIN_SEEDS = (31, 32, 33, 34)
PREP = dict(ncells=(4, 4, 4), temp_melt=2.2, temp_hold=0.80, press=1.0,
            mod=20, melt_records=2, hold_records=1)
CELLS = (8, 4, 4)
TEMPS = (0.70, 0.76, 0.82)
GAP, MOD, RECORDS, CHUNKS = 0.5, 20, 2, 3


def chain(seed: int) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from neuralmelting_tpu import coexist, runner
    from neuralmelting_tpu.models.lj import LJCut
    from neuralmelting_tpu.ops.energy import pair_energy_virial

    t0 = time.perf_counter()
    p = PREP
    liq_pos, liq_box = coexist.prep_liquid(
        "LJ", p["ncells"], temp_melt=p["temp_melt"],
        temp_hold=p["temp_hold"], press=p["press"], seed=seed, mod=p["mod"],
        melt_records=p["melt_records"], hold_records=p["hold_records"])
    n = len(liq_pos)
    pe, _w = pair_energy_virial(LJCut.create(), jnp.asarray(liq_pos),
                                jnp.asarray(liq_box))
    setup = coexist.build_coexist_setup(
        "LJ", CELLS, TEMPS, press=p["press"], liquid_pos=liq_pos,
        liquid_box=liq_box, mod=MOD, gap=GAP)
    rows = []
    for _ in range(CHUNKS):
        setup, recs, _fr, hist, xacc, diag = runner.run_sampling(
            setup, write_files=False, write_traj=False, nrecords=RECORDS,
            exchange=False)
        assert int(diag) == 0 and int(np.asarray(xacc).sum()) == 0
        rows.append(coexist.row_pe_per_atom(
            np.asarray(recs.pe), np.asarray(hist), setup.natoms,
            len(TEMPS)).tolist())
    return {"seed": seed, "seconds": time.perf_counter() - t0,
            "liquid_density": float(n / np.prod(np.asarray(liq_box,
                                                           np.float64))),
            "liquid_pe_per_atom": float(pe) / n,
            "rows": rows}


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "golden", "coexist_relax_jax.json")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    with mp.get_context("spawn").Pool(4) as pool:
        chains = pool.map(chain, CHAIN_SEEDS)
    out = {"script": "tests/make_coexist_reference.py", "device": "cpu",
           "engine": "cellmc", "prep": PREP, "cells": list(CELLS),
           "temps": list(TEMPS), "gap": GAP, "mod": MOD, "records": RECORDS,
           "chunks": CHUNKS, "build_seed": 47, "chain_seeds":
           list(CHAIN_SEEDS), "chains": chains}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    for c in chains:
        gaps = [np.round(np.asarray(r)[1] - np.asarray(r)[0], 3).tolist()
                for r in c["rows"]]
        print(c["seed"], round(c["seconds"], 1),
              round(c["liquid_density"], 4),
              round(c["liquid_pe_per_atom"], 4), gaps)


if __name__ == "__main__":
    main()
