#!/usr/bin/env python
"""JAX reference for the PyTorch port's EAM physics check.

    JAX_PLATFORMS=cpu python scripts/eam_config3_reference.py [OUT.json]

Runs docs/VALIDATION.md config 3, the heating leg as scripts/eam_tm_ab.py
pins it ("glong": gather engine, 4x4x4 fcc Al, P = 1 bar, 10 T in
linspace(400, 2200) K, nsmpl 40, mod 20, ncut 15, dpos0 0.1, dvol0 0.01,
nbins 48, the rc = 3.8 synthetic table), as independent chains of seeds
5-12, one process each, on the CPU. Writes (default
eam_config3_gather.json):

- per temperature slot, the record means of pe/N (eV), V (A^3) and the
  virial pressure (N kB T + W/3)/V (eV/A^3) after the burn-in, pooled
  over the chains, with the standard error of that mean from the spread
  of batch means (5 batches of 5 consecutive records per chain: records
  20 sweeps apart are correlated, batches 100 sweeps apart much less);
- per chain, the slot-ordered mean g(r) features the classifier sees
  (10 x 48), T_m and P(liquid), and T_m with the classifier retrained
  from initial-weight seeds 0-3 on those features.

chip_smoke.py holds the port's chains of the same configuration to the
first, and its classifier on these features to the second.
"""

import json
import multiprocessing as mp
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NATOMS = 256
KB = 8.617333262e-5
NBATCH = 5
CHAIN_SEEDS = tuple(range(5, 13))
CLASSIFIER_SEEDS = range(4)


def config3(seed: int):
    from neuralmelting_tpu.config import RunConfig
    return RunConfig(
        name="eamval", element="AL", ncells=(4, 4, 4), npress=1, ntemp=10,
        press=(1.0,),
        temp=tuple(float(t) for t in np.linspace(400.0, 2200.0, 10)),
        nsmpl=40, mod=20, ncut=15, dpos0=0.1, dvol0=0.01, seed=seed)


def batches(a):
    """(NBATCH, ...) means of consecutive blocks of the records."""
    return np.stack([c.mean(0) for c in np.array_split(a, NBATCH)])


def chain(seed: int) -> dict:
    """One config-3 heating leg: batch means and features."""
    import jax

    from neuralmelting_tpu import pipeline as P
    from neuralmelting_tpu import runner
    from neuralmelting_tpu.models.eam_gen import write_setfl
    from neuralmelting_tpu.neural.melt import melting_curve
    from neuralmelting_tpu.neural.models import PhaseCNN
    from neuralmelting_tpu.neural.scalers import get_scaler
    from neuralmelting_tpu.neural.train import (extreme_t_labels,
                                                train_classifier)

    cfg = config3(seed)
    table = os.path.join(tempfile.mkdtemp(prefix="nm_ref_"),
                         "al38.eam.alloy")
    write_setfl(table, rc=3.8)
    cap = {}
    orig = runner.run_sampling

    def spy(*a, **k):
        cap["out"] = orig(*a, **k)
        return cap["out"]

    runner.run_sampling = spy
    t0 = time.perf_counter()
    res = P.melting_pipeline(cfg, setfl=table, engine="gather", nbins=48)
    seconds = time.perf_counter() - t0
    _, recs, _, hist, _, _ = cap["out"]
    hist = np.asarray(hist)

    def slot(v):
        return P.slot_order_features(np.asarray(v, np.float64),
                                     hist)[cfg.ncut:]

    temp, vol = slot(recs.temp), slot(recs.vol)
    out = {
        "seed": seed, "seconds": seconds, "diag": int(res.diag),
        "tm_K": float(res.tm[0]), "probs": np.asarray(res.probs[0]).tolist(),
        "records": int(vol.shape[0]),
        "batch_pe_per_atom": batches(slot(recs.pe) / NATOMS).tolist(),
        "batch_vol": batches(vol).tolist(),
        "batch_pvir": batches((NATOMS * KB * temp + slot(recs.virial) / 3.0)
                              / vol).tolist(),
        "g_slot": np.asarray(res.g_slot, np.float64).tolist(),
    }
    x = get_scaler("tanh").fit_transform(jax.numpy.asarray(res.g_slot))
    mask, labels = extreme_t_labels(len(cfg.temp), 1)
    out["tm_over_classifier_seeds_K"] = []
    for s in CLASSIFIER_SEEDS:
        fit = train_classifier(PhaseCNN(), x, mask, labels,
                               jax.random.key(s), epochs=400, lr=2e-3)
        tm, _ = melting_curve(res.temp, np.asarray(fit.probs)[None])
        out["tm_over_classifier_seeds_K"].append(float(tm[0]))
    return out


def pooled(chains, key):
    b = np.concatenate([np.asarray(c[key]) for c in chains])
    return b.mean(0).tolist(), (b.std(0, ddof=1) / np.sqrt(len(b))).tolist()


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "eam_config3_gather.json"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    with mp.get_context("spawn").Pool(len(CHAIN_SEEDS)) as pool:
        chains = pool.map(chain, CHAIN_SEEDS)
    cfg = config3(CHAIN_SEEDS[0])
    out = {"script": "scripts/eam_config3_reference.py", "device": "cpu",
           "engine": "gather", "nbins": 48, "natoms": NATOMS,
           "config": json.loads(cfg.to_json()),
           "chain_seeds": list(CHAIN_SEEDS), "batches_per_chain": NBATCH,
           "temp_K": [float(t) for t in cfg.temp]}
    for key, name in (("batch_pe_per_atom", "pe_per_atom_eV"),
                      ("batch_vol", "vol_A3"),
                      ("batch_pvir", "pvir_eV_per_A3")):
        out[name], out[name + "_se"] = pooled(chains, key)
    out["chains"] = chains
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "chains"}))
    for c in chains:
        print(c["seed"], c["tm_K"], c["seconds"],
              c["tm_over_classifier_seeds_K"])


if __name__ == "__main__":
    main()
