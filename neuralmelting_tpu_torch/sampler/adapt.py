"""Adaptive step-size control (counterpart of
``neuralmelting_tpu.sampler.adapt``), batched over replicas.

Every record block each of dpos/dvol/dt is multiplied by ``factor`` if its
window acceptance ratio exceeds its target and divided by it otherwise,
then clipped; the window counters are zeroed.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.sampler.state import box_volume


def _adapt_one(d, nacc, ntry, target, factor, lo, hi):
    ratio = nacc.to(torch.float32) / torch.clamp(ntry, min=1).to(
        torch.float32)
    scaled = torch.where(ratio > target, d * factor, d / factor)
    d_new = torch.where(ntry > 0, scaled, d)
    return torch.minimum(torch.maximum(d_new, lo), hi)


def adapt_step_sizes(state, targets=(0.5, 0.5, 0.5), factor=1.0625):
    """Returns state with updated dpos/dvol/dt and zeroed window counters."""
    tp, tv, th = targets
    boxmin = torch.min(state.box, dim=-1).values
    vol = box_volume(state.box)
    dpos = _adapt_one(state.dpos, state.nap, state.ntp, tp, factor,
                      1e-5 * boxmin, 0.25 * boxmin)
    dvol = _adapt_one(state.dvol, state.nav, state.ntv, tv, factor,
                      1e-8 * vol, 0.5 * vol)
    ones = torch.ones_like(state.dt)
    dt = _adapt_one(state.dt, state.nah, state.nth, th, factor,
                    1e-8 * ones, 1e3 * ones)
    zero = torch.zeros_like
    return state.replace(dpos=dpos, dvol=dvol, dt=dt,
                         nap=zero(state.nap), ntp=zero(state.ntp),
                         nav=zero(state.nav), ntv=zero(state.ntv),
                         nah=zero(state.nah), nth=zero(state.nth))
