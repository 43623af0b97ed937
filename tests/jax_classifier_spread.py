#!/usr/bin/env python
"""The JAX package's north-star classifier over initial-weight keys.

    JAX_PLATFORMS=cpu python tests/jax_classifier_spread.py STATE [LO:HI]

Trains ``scripts/northstar2.py``'s classifier (tanh scaler, the JAX
PhaseCNN, extreme-T labels of band ntemp // 8, 400 epochs, lr 2e-3) once
from each ``jax.random.key(k)``, k in LO:HI (default 0:16), on the
features a north-star run of the port saved in STATE (``feat_NNN.npz``,
as ``python -m neuralmelting_tpu_torch.northstar`` or chip_smoke's
northstar phase write them; their mean is what the run trains on), and
prints T_m(P*=1) of each and their mean and sd as one JSON line, beside
which ``python -m neuralmelting_tpu_torch.classifier_spread STATE`` gives
the port's classifier over its seeds (ROADMAP C11). ~3 minutes a training
on the CPU.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neuralmelting_tpu.neural.melt import melting_curve  # noqa: E402
from neuralmelting_tpu.neural.models import PhaseCNN  # noqa: E402
from neuralmelting_tpu.neural.scalers import get_scaler  # noqa: E402
from neuralmelting_tpu.neural.train import (extreme_t_labels,  # noqa: E402
                                            train_classifier)
from neuralmelting_tpu_torch import northstar  # noqa: E402
from neuralmelting_tpu_torch.config import grids  # noqa: E402


def main(argv):
    state = argv[0]
    lo, hi = (int(v) for v in (argv[1] if len(argv) > 1 else "0:16")
              .split(":"))
    cfg = northstar.make_cfg()
    _, temp = grids(cfg)
    npress, ntemp = cfg.npress, len(temp)
    g, _ = northstar.saved_features(state,
                                    northstar.schedule()["samp_chunks"])
    x = get_scaler("tanh").fit_transform(jnp.asarray(g, jnp.float32))
    mask, labels = extreme_t_labels(ntemp, max(1, ntemp // 8))
    tms = []
    for k in range(lo, hi):
        res = train_classifier(PhaseCNN(), x, jnp.tile(mask, npress),
                               jnp.tile(labels, npress), jax.random.key(k),
                               epochs=400, lr=2e-3)
        tm, _ = melting_curve(temp, np.asarray(res.probs).reshape(npress,
                                                                  ntemp))
        tms.append(float(tm[0]))
        print(k, tms[-1], file=sys.stderr, flush=True)
    print(json.dumps({"keys": [lo, hi], "tm_p1": tms,
                      "mean": float(np.mean(tms)),
                      "sd": float(np.std(tms, ddof=1)) if len(tms) > 1
                      else 0.0}))


if __name__ == "__main__":
    main(sys.argv[1:])
