"""The north star's T_m(P*=1) over classifier initial weights.

    python -m neuralmelting_tpu_torch.classifier_spread STATE
        [--seeds LO:HI] [--fast] [--device cuda|cpu]

Trains the north star's classifier (``northstar.classify``: tanh scaler,
CNN, extreme-T labels of band ntemp // 8, 400 epochs) once from each
initial-weight seed on the features a north-star run saved in ``STATE``
(``northstar.saved_features``: the mean over its sampled chunks'
``feat_NNN.npz``) and prints T_m(P*=1) of each, their mean and sd as one
JSON line. On the card it trains with cuDNN's deterministic algorithms,
so the list repeats on one tree: the north star's own single training
(seed 3, default algorithms) does not, and its T_m depends on the
initial weights (ROADMAP C11). ``--fast`` reads a ``--fast`` run's
features. Runs on the card unless given ``--device cpu``; without a GPU
the default raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from neuralmelting_tpu_torch import northstar as NS
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import grids


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block."""
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def trainings(g, cfg, seeds, device) -> list:
    """T_m(P*=1) of the classifier trained from each seed on features g
    (R, NBINS) of config ``cfg``'s (P, T) grid."""
    _, temp = grids(cfg)
    x = torch.as_tensor(g, dtype=torch.float32, device=device)
    with deterministic_cudnn():
        return [float(NS.classify(temp, x, cfg.npress, len(temp),
                                  seed=seed)[0][0]) for seed in seeds]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("state", help="a north-star run's state directory")
    ap.add_argument("--seeds", default="0:16",
                    help="initial-weight seeds LO:HI (default 0:16)")
    ap.add_argument("--fast", action="store_true",
                    help="the features of a --fast run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    lo, hi = (int(v) for v in args.seeds.split(":"))
    dev = runner.resolve_device(args.device)
    g, _ = NS.saved_features(args.state,
                             NS.schedule(args.fast)["samp_chunks"])
    tms = trainings(g, NS.make_cfg(args.fast), range(lo, hi), dev)
    out = {"seeds": [lo, hi], "tm_p1": tms, "mean": float(np.mean(tms)),
           "sd": float(np.std(tms, ddof=1)) if len(tms) > 1 else 0.0,
           "anchor": NS.ANCHOR}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
