"""Stage 4 — phase classifier + T_m extraction (reference:
lammps_neural.py; counterpart of ``neuralmelting_tpu.cli.neural``, the
same npz keys), trained on ``--device`` (default: the card) from initial
weights drawn by ``torch.Generator().manual_seed(--seed)``.

    python -m neuralmelting_tpu_torch.cli.neural -i out/remcmc.lj.fcc.4x4x4.rdf.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from neuralmelting_tpu_torch.cli.common import add_device_arg
from neuralmelting_tpu_torch.neural.melt import melting_curve
from neuralmelting_tpu_torch.neural.models import (PhaseCNN, PhaseMLP,
                                                   init_params)
from neuralmelting_tpu_torch.neural.scalers import get_scaler
from neuralmelting_tpu_torch.neural.train import (extreme_t_labels,
                                                  train_classifier)
from neuralmelting_tpu_torch.runner import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True, help="rdf .npz")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--scaler", default="tanh",
                    choices=("minmax", "standard", "robust", "tanh"))
    ap.add_argument("--model", default="cnn", choices=("cnn", "mlp"))
    ap.add_argument("--band", type=int, default=0,
                    help="extreme-T training band width (default ntemp//8)")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    z = np.load(args.input, allow_pickle=True)
    g_mean = z["g_mean"]                          # (npress, ntemp, nbins)
    npress, ntemp, nbins = g_mean.shape
    temps = z["temp"] if z["temp"] is not None and z["temp"].ndim else None
    temp_grid = (np.asarray(temps)[0] if temps is not None
                 else np.arange(ntemp, dtype=float))

    band = args.band or max(1, ntemp // 8)
    sc = get_scaler(args.scaler)
    x = sc.fit_transform(torch.as_tensor(
        np.asarray(g_mean.reshape(-1, nbins), np.float32), device=dev))
    mask1, labels1 = extreme_t_labels(ntemp, band, device=dev)
    mask = mask1.repeat(npress)
    labels = labels1.repeat(npress)
    net = (PhaseCNN(nbins) if args.model == "cnn" else PhaseMLP(nbins)).to(dev)
    init_params(net, torch.Generator().manual_seed(args.seed))
    res = train_classifier(net, x, mask, labels, epochs=args.epochs,
                           lr=args.lr)
    probs = res.probs.cpu().numpy().reshape(npress, ntemp)
    tms, widths = melting_curve(temp_grid, probs)

    out = args.out or args.input.replace(".rdf.npz", ".melt.npz")
    np.savez_compressed(out, probs=probs, tm=tms, width=widths,
                        temp=temp_grid,
                        press=(z["press"][:, 0] if z["press"] is not None
                               and np.ndim(z["press"]) else
                               np.arange(npress, dtype=float)),
                        losses=res.losses.cpu().numpy())
    print(f"T_m per pressure: {tms} -> {out}")


if __name__ == "__main__":
    main()
