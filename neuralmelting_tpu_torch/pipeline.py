"""The melting-curve pipeline on one device (counterpart of
``neuralmelting_tpu.pipeline``): sampling -> g(r) and S(q) -> extreme-T
phase classifier -> T_m per pressure, from one call.

Sampling runs on the gather engine (the default, as in the JAX package)
or the cellmc engine, each for LJ and EAM, or the dense engine (LJ), in
one process; trajectories
stay on the device through featurization, and only the slot-ordering of
features and the logistic fits run on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.features.rdf import rdf_frames, structure_factor
from neuralmelting_tpu_torch.neural.melt import melting_curve
from neuralmelting_tpu_torch.neural.models import (PhaseCNN, PhaseMLP,
                                                   init_params)
from neuralmelting_tpu_torch.neural.scalers import get_scaler
from neuralmelting_tpu_torch.neural.train import (extreme_t_labels, full_f32,
                                                  train_classifier)


@dataclasses.dataclass
class MeltingResult:
    press: np.ndarray          # (npress,)
    temp: np.ndarray           # (ntemp,)
    tm: np.ndarray             # (npress,) melting temperatures
    width: np.ndarray          # (npress,) sigmoid widths
    probs: np.ndarray          # (npress, ntemp) P(liquid)
    g_slot: np.ndarray         # (R, nbins) mean g(r) per slot
    sq_slot: np.ndarray        # (R, nq) S(q) per slot
    q: np.ndarray
    rmax: float
    losses: np.ndarray
    xacc: np.ndarray
    diag: int
    classifier: Optional[tuple] = None   # (net, state dict, fitted scaler)
    # port additions: attempted MC moves of the run and host seconds per
    # stage (sampling includes setup), each read after a device sync
    moves_tried: int = 0
    seconds: dict = dataclasses.field(default_factory=dict)
    records: object = None               # the sampling chunk's records


def slot_order_features(values, hist):
    """Reorder per-replica per-record features into slot order.

    values: (nrec, R, ...); hist: (nrec, R) replica->slot.
    Returns (nrec, R, ...) where axis 1 is the SLOT index.
    """
    hist = np.asarray(hist)
    nrec, r = hist.shape
    out = np.empty_like(np.asarray(values))
    vals = np.asarray(values)
    for k in range(nrec):
        perm = np.argsort(hist[k])   # slot -> replica
        out[k] = vals[k][perm]
    return out


def melting_pipeline(cfg: RunConfig, setfl: Optional[str] = None,
                     nbins: int = 64, scaler: str = "tanh",
                     model: str = "cnn", band: int = 0,
                     epochs: int = 400, lr: float = 2e-3,
                     seed: int = 0, engine: str = "gather",
                     init: str = "lattice",
                     classify_with: Optional[MeltingResult] = None,
                     device="cuda") -> MeltingResult:
    """The JAX signature plus ``device``, the card unless the caller asks
    for "cpu" (without a usable GPU the default raises). Runs
    ``engine="gather"`` (with HMC when ``cfg.phmc > 0``) and
    ``engine="cellmc"``, each for LJ and for EAM (``element="AL"``, the
    setfl table ``setfl`` or the synthetic Al table), and
    ``engine="dense"`` for LJ; other engines raise NotImplementedError
    naming their ROADMAP item.

    init="liquid" pre-melts every replica (runner.liquid_start) for the
    cooling-leg estimate and needs ``classify_with``, the heating leg's
    result: extreme-T labels are valid only on a lattice start.
    ``seed`` seeds the classifier's initial weights.
    """
    if init == "liquid" and classify_with is None:
        raise ValueError(
            "init='liquid' requires classify_with=<heating-leg result>: "
            "extreme-T labels are invalid on a liquid start")
    dev = runner.resolve_device(device)
    t0 = runner.timed(dev)
    setup = runner.setup_run(cfg, setfl, engine=engine, device=dev)
    rmax = 0.48 * float(torch.min(setup.states.box[0]))
    if init == "liquid":
        setup = runner.liquid_start(setup)
    setup, recs, frames, hist, xacc, diag = runner.run_sampling(
        setup, write_traj=True)
    t1 = runner.timed(dev)

    # --- features: g(r) per recorded frame, slot-ordered, burn-in cut
    pos, boxes = frames                  # (nrec, R, N, 3), (nrec, R, 3)
    nrec, r, n = pos.shape[0], pos.shape[1], pos.shape[2]
    g = rdf_frames(pos.reshape(nrec * r, n, 3), boxes.reshape(nrec * r, 3),
                   nbins, rmax).reshape(nrec, r, nbins)
    hist_np = hist.cpu().numpy()
    g_slot = slot_order_features(g.cpu().numpy(), hist_np)
    box_slot = slot_order_features(boxes.cpu().numpy(), hist_np)
    cut = min(cfg.ncut, nrec - 1)
    feats = torch.as_tensor(g_slot[cut:].mean(axis=0), dtype=torch.float32,
                            device=dev)                        # (R, nbins)
    box_mean = torch.as_tensor(box_slot[cut:].mean(axis=0), device=dev)
    q, sq = structure_factor(feats, box_mean, setup.natoms, rmax)
    t2 = runner.timed(dev)

    npress, ntemp = len(setup.press), len(setup.temp)
    if classify_with is not None:
        # apply the heating leg's classifier in ITS feature space
        net, params, sc = classify_with.classifier
        with torch.no_grad(), full_f32():
            probs = torch.sigmoid(net(sc.transform(feats)))
        probs = probs.cpu().numpy().reshape(npress, ntemp)
        losses = np.zeros((0,), np.float32)
        clf = classify_with.classifier
    else:
        if band <= 0:
            band = max(1, ntemp // 8)
        sc = get_scaler(scaler)
        x = sc.fit_transform(feats)
        mask1, labels1 = extreme_t_labels(ntemp, band, device=dev)
        mask = mask1.repeat(npress)
        labels = labels1.repeat(npress)
        net = (PhaseCNN(nbins) if model == "cnn" else PhaseMLP(nbins)).to(dev)
        gen = torch.Generator().manual_seed(int(seed))
        init_params(net, gen)
        res = train_classifier(net, x, mask, labels, epochs=epochs, lr=lr)
        probs = res.probs.cpu().numpy().reshape(npress, ntemp)
        losses = res.losses.cpu().numpy()
        clf = (net, res.params, sc)

    # --- melting temperatures per pressure
    tms, widths = melting_curve(setup.temp, probs)
    t3 = runner.timed(dev)

    return MeltingResult(
        press=setup.press, temp=setup.temp, tm=tms, width=widths,
        probs=probs, g_slot=feats.cpu().numpy(), sq_slot=sq.cpu().numpy(),
        q=q.cpu().numpy(), rmax=rmax, losses=losses,
        xacc=xacc.cpu().numpy(), diag=int(diag), classifier=clf,
        moves_tried=int(setup.moves_tried),
        seconds={"sampling": t1 - t0, "features": t2 - t1,
                 "classifier": t3 - t2},
        records=recs)
