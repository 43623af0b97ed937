"""Melting temperature from P(liquid) vs T (counterpart of
``neuralmelting_tpu.neural.melt``): per pressure, a damped Gauss-Newton
fit of the logistic P = 1 / (1 + exp(-(T - Tm)/w)), in f32 torch with the
analytic Jacobian in (Tm, log w)."""

from __future__ import annotations

import numpy as np
import torch


def logistic(t, tm, w):
    return 1.0 / (1.0 + torch.exp(-(t - tm) / w))


def fit_melting_temperature(temps, probs, iters: int = 60):
    """Fit P(liquid)(T) = logistic((T - Tm)/w). Returns (tm, w) as 0-d
    f32 tensors. temps, probs: (ntemp,)."""
    temps = torch.as_tensor(np.asarray(temps), dtype=torch.float32)
    probs = torch.as_tensor(np.asarray(probs), dtype=torch.float32)
    tm = temps[torch.argmin(torch.abs(probs - 0.5))]
    w0 = 0.25 * (temps[-1] - temps[0]) / max(len(temps) - 1, 1) * 4.0
    p = torch.stack([tm, torch.log(w0)])
    eye = torch.eye(2, dtype=torch.float32)
    for _ in range(iters):
        tm, lw = p[0], p[1]
        w = torch.exp(lw)
        z = (temps - tm) / w
        s = 1.0 / (1.0 + torch.exp(-z))
        r = s - probs
        ds = s * (1.0 - s)
        j = torch.stack([-ds / w, -ds * z], dim=1)      # (ntemp, 2)
        jtj = j.T @ j + 1e-4 * eye
        p = p - torch.linalg.solve(jtj, j.T @ r)
    return p[0], torch.exp(p[1])


def melting_curve(temps, probs_grid):
    """T_m and width per pressure row of probs_grid (npress, ntemp)."""
    tms, widths = [], []
    for row in np.asarray(probs_grid):
        tm, w = fit_melting_temperature(np.asarray(temps), row)
        tms.append(float(tm))
        widths.append(float(w))
    return np.asarray(tms), np.asarray(widths)


def crossing_resolved(temps, probs_grid, tms):
    """Per-row mask: does the row span 0.5 AND does its fitted midpoint lie
    inside the scanned grid (padded by one spacing)? A fit without that is
    a censored observation, not an estimate."""
    temps = np.asarray(temps, np.float64)
    pad = (temps[-1] - temps[0]) / max(len(temps) - 1, 1)
    grid = np.asarray(probs_grid, np.float64)
    tms = np.asarray(tms, np.float64)
    spans = (grid.min(axis=1) < 0.5) & (grid.max(axis=1) > 0.5)
    in_grid = (tms >= temps[0] - pad) & (tms <= temps[-1] + pad)
    return spans & in_grid
