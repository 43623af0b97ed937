#!/usr/bin/env python
"""JAX reference for the PyTorch port's LJ physics check.

    JAX_PLATFORMS=cpu python tests/make_lj_validation.py [OUT.json]

Runs the docs/VALIDATION.md LJ configuration (4x4x4 fcc = 256 atoms,
P* = (1, 5), 12 temperatures in linspace(0.55, 1.45), nsmpl 40, mod 20,
ncut 15, dpos0 0.1, dvol0 0.01; melting_pipeline with nbins 48, the MLP,
400 epochs, band 2, classifier seed 0) through the JAX package's
default (gather) engine as independent chains of seeds 7-14, one process
each (four at a time), on the CPU. Writes each chain's T_m(P*) and
P(liquid), and the chains' mean and standard deviation of T_m(P*=1), to
tests/golden/lj_validation_gather.json (or OUT.json).

chip_smoke.py's physics phase gates the mean T_m(P*=1) of the port's
chains of the same seeds to within 2% of 0.78, prints these chains
beside them, and from their mean and spread the smallest steady bias of
the port's mean that the gate catches.
"""

import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHAIN_SEEDS = tuple(range(7, 15))


def config(seed: int):
    from neuralmelting_tpu.config import RunConfig
    return RunConfig(name="val", element="LJ", ncells=(4, 4, 4), npress=2,
                     ntemp=12, press=(1.0, 5.0),
                     temp=tuple(float(t) for t in np.linspace(0.55, 1.45, 12)),
                     nsmpl=40, mod=20, ncut=15, seed=seed, dpos0=0.1,
                     dvol0=0.01)


def chain(seed: int) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from neuralmelting_tpu.pipeline import melting_pipeline

    t0 = time.perf_counter()
    res = melting_pipeline(config(seed), nbins=48, model="mlp", epochs=400,
                           band=2)
    return {"seed": seed, "seconds": time.perf_counter() - t0,
            "diag": int(res.diag), "tm": [float(t) for t in res.tm],
            "probs": np.asarray(res.probs).tolist()}


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "golden", "lj_validation_gather.json")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    with mp.get_context("spawn").Pool(4) as pool:
        chains = pool.map(chain, CHAIN_SEEDS)
    tm1 = np.asarray([c["tm"][0] for c in chains])
    cfg = config(CHAIN_SEEDS[0])
    out = {"script": "tests/make_lj_validation.py", "device": "cpu",
           "engine": "gather", "nbins": 48, "model": "mlp", "epochs": 400,
           "band": 2, "classifier_seed": 0,
           "config": json.loads(cfg.to_json()),
           "chain_seeds": list(CHAIN_SEEDS),
           "press": list(cfg.press), "temp": [float(t) for t in cfg.temp],
           "tm_p1_mean": float(tm1.mean()),
           "tm_p1_std": float(tm1.std(ddof=1)),
           "chains": chains}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "chains"}))
    for c in chains:
        print(c["seed"], c["tm"], round(c["seconds"], 1))


if __name__ == "__main__":
    main()
