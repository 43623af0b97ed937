"""The three NPT Monte Carlo moves of one serial chain.

Counterpart of ``neuralmelting_tpu.sampler.moves``: the same
``EnergyBackend`` triple and the same acceptance rules (beta = 1/(kb T)):

  position:  min(1, exp(-beta dE))
  volume:    min(1, exp(-beta (dE + P p2e dV) + N ln(V'/V)))   [NPT weight]
  HMC:       min(1, exp(-beta dH)), dH = dPE + dKE

``position_move``, ``volume_move`` and ``hmc_move`` keep the JAX API
``(..., state, key) -> state``: each draws from its ``jax.random`` key as
the JAX move does (``ops/jrandom.py``) and updates ``state`` in place.
Each is split in two: ``*_draws`` makes the draws on the key's device
(the host), independent of the state, and ``position``, ``volume`` and
``hmc`` apply a move from its draws on the state's device, without
reading anything back from it. The serial sweep (``sampler/serial.py``)
makes a whole sweep's draws in one batch and calls the appliers, so no
attempt waits on the card.

The appliers leave the try/accept counters to the caller and return the
acceptance (a 0-dim bool tensor on the state's device) with the log of
the acceptance weight it was decided on (accept iff ln u < weight).

Where the arithmetic is not the JAX package's: the volume move's cube
root is computed in f64 and rounded to f32 (torch has no f32 cbrt);
``jnp.cbrt`` on the CPU is not correctly rounded and differs from it by
one ulp on about 0.1% of the ratios a volume move meets
(tests/test_torch_jrandom.py measures it). Sums are taken in torch's
order, and multiply-adds are not contracted as XLA's CPU backend
contracts them: f32 rounding, not bits, separates the two chains, and
a decision differs only where its margin is at that rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler.state import box_volume


@dataclasses.dataclass(frozen=True)
class EnergyBackend:
    """total(pot,pos,box)->(pe,vir); delta_move(pot,pos,box,i,ri)->(dE,dW);
    forces(pot,pos,box)->(N,3)."""
    total: Callable
    delta_move: Callable
    forces: Callable


def brute_backend() -> EnergyBackend:
    """Brute-force O(N^2) energies; the incremental one is kernel B5 on a
    CUDA tensor and its plain version on a CPU tensor."""
    from neuralmelting_tpu_torch.ops import energy, lj_delta

    def delta_move(pot, pos, box, i, new_ri):
        # index with the tensor itself: a device index is never read back
        ids = torch.as_tensor(i, dtype=torch.int32,
                              device=pos.device).reshape(1)
        de, dw = lj_delta.delta_moves(
            pot, pos[None], box[None], ids.reshape(1, 1),
            pos.index_select(0, ids).reshape(1, 1, 3),
            new_ri.reshape(1, 1, 3))
        return de.reshape(()), dw.reshape(())

    return EnergyBackend(total=energy.pair_energy_virial,
                         delta_move=delta_move, forces=energy.forces)


def wrap_pos(pos, box):
    return pos - box * torch.floor(pos / box)


def cbrt(x):
    """f32 cube root of positive x, computed in f64 and rounded once."""
    return torch.pow(x.double(), 1.0 / 3.0).float()


def log_u(k):
    """ln of the acceptance uniform: ``log(uniform(k, (), 1e-38, 1))``."""
    return torch.log(jrandom.uniform(k, (), 1e-38, 1.0))


# ---------------------------------------------------------------------------
# draws (host, from keys; batched over leading key axes)
# ---------------------------------------------------------------------------

def position_draws(km, n: int):
    """(atom index int32, displacement floats in [0, 1) (..., 3), ln u)."""
    ki, kd, ka = jrandom.split(km, 3).unbind(-2)
    return (jrandom.randint(ki, (), 0, n),
            jrandom.floats01(jrandom.random_bits(kd, (3,))), log_u(ka))


def volume_draws(km):
    """(2u - 1 of the volume step, ln u)."""
    kd, ka = jrandom.split(km, 2).unbind(-2)
    return 2.0 * jrandom.uniform(kd) - 1.0, log_u(ka)


def hmc_draws(km, n: int):
    """(standard normal velocities (..., n, 3), ln u)."""
    kv, ka = jrandom.split(km, 2).unbind(-2)
    return jrandom.normal(kv, (n, 3)), log_u(ka)


# ---------------------------------------------------------------------------
# moves from their draws (the state's device)
# ---------------------------------------------------------------------------

def displacement(state, frac):
    """Displacement fractions in [0, 1) (..., 3) scaled to [-dpos, dpos),
    as ``uniform(kd, (3,), minval=-dpos, maxval=dpos)``."""
    return jrandom.scale_uniform(frac, -state.dpos, state.dpos)


def position(pot, backend, state, nbeta, i: int, i_dev, disp, ln_u):
    """Single-particle displacement trial (reference 'PMC') of atom ``i``
    (a host int; ``i_dev`` the same index on the state's device) by
    ``disp`` (``displacement``); nbeta = -1/(kb T)."""
    old = state.pos[i]
    new_ri = old + disp
    de, dw = backend.delta_move(pot, state.pos, state.box, i_dev, new_ri)
    weight = nbeta * de
    acc = ln_u < weight
    state.pos[i] = torch.where(acc, wrap_pos(new_ri, state.box), old)
    state.pe.add_(torch.where(acc, de, 0.0))
    state.virial.add_(torch.where(acc, dw, 0.0))
    return acc, weight


def volume(pot, p2e, backend, state, nbeta, v2u, ln_u):
    """Isotropic volume trial V' = V + dvol (2u - 1), box and coordinates
    rescaled; ``v2u`` = 2u - 1."""
    n = state.pos.shape[0]
    vol = box_volume(state.box)
    dv = state.dvol * v2u
    vol_new = vol + dv
    valid = vol_new > 0.0
    ratio = vol_new / vol
    s = torch.where(valid, cbrt(ratio), 1.0)
    pos_new = state.pos * s
    box_new = state.box * s
    pe_new, vir_new = backend.total(pot, pos_new, box_new)
    ln_acc = (nbeta * ((pe_new - state.pe) + state.press * p2e * dv)
              + n * torch.log(torch.where(valid, ratio, 1.0)))
    acc = valid & (ln_u < ln_acc)
    state.pos = torch.where(acc, pos_new, state.pos)
    state.box = torch.where(acc, box_new, state.box)
    state.pe = torch.where(acc, pe_new, state.pe)
    state.virial = torch.where(acc, vir_new, state.virial)
    return acc, ln_acc


def hmc(pot, kb, backend, state, nbeta, normals, ln_u, nstps: int,
        mass: float):
    """Hybrid MC: Maxwell-Boltzmann velocities from ``normals`` (N, 3),
    then ``nstps`` velocity-Verlet steps (the reference's LAMMPS
    ``velocity create`` + ``run``)."""
    sigma_v = torch.sqrt(kb * state.temp / mass)
    vel = sigma_v * normals
    ke0 = 0.5 * mass * torch.sum(vel * vel)
    dt = state.dt
    half = 0.5 * dt / mass
    pos = state.pos
    f = backend.forces(pot, pos, state.box)
    for _ in range(nstps):
        vel_half = vel + half * f
        pos = pos + dt * vel_half
        f = backend.forces(pot, pos, state.box)
        vel = vel_half + half * f
    pe_new, vir_new = backend.total(pot, pos, state.box)
    ke1 = 0.5 * mass * torch.sum(vel * vel)
    dh = (pe_new - state.pe) + (ke1 - ke0)
    weight = nbeta * dh
    acc = ln_u < weight
    state.pos = torch.where(acc, wrap_pos(pos, state.box), state.pos)
    state.pe = torch.where(acc, pe_new, state.pe)
    state.virial = torch.where(acc, vir_new, state.virial)
    return acc, weight


# ---------------------------------------------------------------------------
# the JAX API: one move from its key
# ---------------------------------------------------------------------------

def _nbeta(kb, state):
    return -(1.0 / (kb * state.temp))


def _to(t, state):
    return t.to(state.pos.device)


def position_move(pot, kb, backend, state, key):
    """One position trial from ``key``; updates ``state`` in place."""
    i, frac, ln_u = position_draws(key, state.pos.shape[0])
    acc, _ = position(pot, backend, state, _nbeta(kb, state), int(i),
                      _to(i, state), displacement(state, _to(frac, state)),
                      _to(ln_u, state))
    state.nap += acc.to(torch.int32)
    state.ntp += 1
    return state


def volume_move(pot, kb, p2e, backend, state, key):
    """One volume trial from ``key``; updates ``state`` in place."""
    v2u, ln_u = volume_draws(key)
    acc, _ = volume(pot, p2e, backend, state, _nbeta(kb, state),
                    _to(v2u, state), _to(ln_u, state))
    state.nav += acc.to(torch.int32)
    state.ntv += 1
    return state


def hmc_move(pot, kb, backend, state, key, nstps: int, mass: float):
    """One HMC trial from ``key``; updates ``state`` in place."""
    normals, ln_u = hmc_draws(key, state.pos.shape[0])
    acc, _ = hmc(pot, kb, backend, state, _nbeta(kb, state),
                 _to(normals, state), _to(ln_u, state), nstps, mass)
    state.nah += acc.to(torch.int32)
    state.nth += 1
    return state
