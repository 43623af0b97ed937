"""Serial-compatible NPT Metropolis sweep of one chain.

Counterpart of ``neuralmelting_tpu.sampler.serial``: the reference's
move-by-move semantics, one sweep = N attempts, each drawing its move
type against the cumulative probabilities (ppos, ppos + pvol, 1) and
running a single-particle displacement, a volume trial or an HMC
trajectory. The golden-file path (BASELINE config 1,
``tests/golden/config1.*``).

RNG contract, as in the JAX package: per sweep, ``keys = split(key,
N+1)``; ``keys[0]`` becomes the next key; attempt ``a`` uses ``kt, km =
split(keys[1+a])`` for its type draw ``uniform(kt)`` and its move.

The key tree depends on the key alone, so a sweep derives it on the host
(``ops/jrandom.py``) before its moves: the move types, and every draw of
the sweep in one batch per move type (atom indices, displacement
fractions, volume steps, HMC normals, acceptance uniforms), copied to the
state's device once. Displacements are scaled to [-dpos, dpos) on the
device, where dpos lives (it changes only at records). The sweep then
walks the attempts in runs: each run of consecutive position attempts
goes to ``moves.position_run`` at once (on the card, one launch of kernel
B5 for the whole run), each volume or HMC attempt to its own applier.
Nothing is read back, so the host runs ahead of the card. The type
thresholds are f32(ppos) and f32(ppos + pvol), the sum taken in f64 as in
the JAX comparison ``u < ppos + pvol``.
"""

from __future__ import annotations

import numpy as np
import torch

from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler import moves

POS, VOL, HMC = 0, 1, 2


def _to_device(t, device):
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def attempt_runs(mtypes):
    """[(move type, first attempt, end attempt)] of a sweep's move types
    in order: each run of consecutive position attempts as one entry,
    every volume and HMC attempt as its own."""
    runs = []
    for a, t in enumerate(mtypes):
        if t == POS and runs and runs[-1][0] == POS and runs[-1][2] == a:
            runs[-1] = (POS, runs[-1][1], a + 1)
        else:
            runs.append((t, a, a + 1))
    return runs


def make_sweep_fn(kb, p2e, backend, ppos, pvol, nstps, mass, trace=None):
    """Build ``sweep(pot, state) -> state`` for one serial sweep of N
    attempts; ``state`` is updated in place.

    ``trace``, if a list, receives one entry per sweep: (move types (N,)
    on the host, acceptances (N,) bool and margins ln u - ln(acceptance
    weight) (N,) f32 on the state's device), the record a divergence
    between two chains is located with."""
    t_pos = float(np.float32(ppos))
    t_vol = float(np.float32(ppos + pvol))

    def sweep(pot, state):
        n = state.pos.shape[0]
        dev = state.pos.device
        keys = jrandom.split(state.key, n + 1)
        state.key = keys[0].clone()
        kt, km = jrandom.split(keys[1:], 2).unbind(-2)
        u = jrandom.uniform(kt)
        mtype = torch.where(u < t_pos, POS, torch.where(u < t_vol, VOL, HMC))
        sel = [torch.nonzero(mtype == t).reshape(-1) for t in (POS, VOL, HMC)]
        idx, frac, lnu_p = moves.position_draws(km[sel[POS]], n)
        v2u, lnu_v = moves.volume_draws(km[sel[VOL]])
        normals, lnu_h = moves.hmc_draws(km[sel[HMC]], n)
        (idx_d, frac_d, lnu_p, v2u, lnu_v, normals, lnu_h, mtype_d) = (
            _to_device(t, dev) for t in (idx, frac, lnu_p, v2u, lnu_v,
                                         normals, lnu_h, mtype))
        disp = moves.displacement(state, frac_d)
        nbeta = -(1.0 / (kb * state.temp))
        acc = torch.zeros(n, dtype=torch.bool, device=dev)
        margin = torch.zeros(n, dtype=torch.float32, device=dev) \
            if trace is not None else None
        seen = [0, 0, 0]
        for t, a0, a1 in attempt_runs(mtype.tolist()):
            j = seen[t]
            seen[t] += a1 - a0
            if t == POS:
                lnu = lnu_p[j:seen[t]]
                ok, w = moves.position_run(pot, backend, state, nbeta,
                                           idx_d[j:seen[t]],
                                           disp[j:seen[t]], lnu)
            elif t == VOL:
                lnu = lnu_v[j]
                ok, w = moves.volume(pot, p2e, backend, state, nbeta,
                                     v2u[j], lnu)
            else:
                lnu = lnu_h[j]
                ok, w = moves.hmc(pot, kb, backend, state, nbeta,
                                  normals[j], lnu, nstps, mass)
            acc[a0:a1] = ok
            if margin is not None:
                margin[a0:a1] = lnu - w
        for t, (na, nt) in enumerate((("nap", "ntp"), ("nav", "ntv"),
                                      ("nah", "nth"))):
            getattr(state, na).add_(((mtype_d == t) & acc).sum()
                                    .to(torch.int32))
            getattr(state, nt).add_(seen[t])
        state.sweep.add_(1)
        if trace is not None:
            trace.append((mtype, acc, margin))
        return state

    return sweep
