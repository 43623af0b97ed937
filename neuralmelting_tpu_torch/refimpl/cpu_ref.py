"""Slow, loop-based CPU reference NPT Metropolis MC (counterpart of
``neuralmelting_tpu.refimpl.cpu_ref``).

A test oracle, not an entry point: it runs on the CPU by design and has
no kernel. It plays the role of the reference's LAMMPS-backed CPU run
for golden-file tests (BASELINE config 1): an independent implementation
of the physics (numpy f64 energies, explicit Python loops) that shares
only the RNG stream contract with the serial engine
(``sampler/serial.py``), so trajectories are comparable move by move
under a fixed seed. The branch compares are in f32 and the HMC leapfrog
runs in f32, as the serial engine does them.

Every draw comes from the port's ``ops/jrandom.py`` on CPU tensors, and
``RefState.key`` holds the port's key (two uint32 words in int64). Those
draws equal ``jax.random``'s bit for bit, but for ``normal``, which
differs by a few f32 ulps on about 1% of draws (``ops/jrandom.py``): the
HMC velocities.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neuralmelting_tpu_torch.ops import jrandom


@dataclasses.dataclass
class RefState:
    pos: np.ndarray
    box: np.ndarray
    key: torch.Tensor
    pe: float
    virial: float
    temp: float
    press: float
    dpos: float
    dvol: float
    dt: float
    nap: int = 0
    ntp: int = 0
    nav: int = 0
    ntv: int = 0
    nah: int = 0
    nth: int = 0
    sweep: int = 0


def _pair_terms(pos, box, eps, sigma, rc):
    d = pos[None, :, :] - pos[:, None, :]
    d -= box * np.round(d / box)
    r2 = (d ** 2).sum(-1)
    np.fill_diagonal(r2, np.inf)
    mask = r2 < rc * rc
    sr6 = np.where(mask, (sigma * sigma / np.where(mask, r2, 1.0)) ** 3, 0.0)
    e = 4 * eps * (sr6 * sr6 - sr6)
    w = 24 * eps * (2 * sr6 * sr6 - sr6)
    return e, w


def total_energy(pos, box, eps, sigma, rc):
    e, w = _pair_terms(pos, box, eps, sigma, rc)
    return 0.5 * e.sum(), 0.5 * w.sum()


def _one_particle(pos, box, i, ri, eps, sigma, rc):
    d = pos - ri
    d -= box * np.round(d / box)
    r2 = (d ** 2).sum(-1)
    r2[i] = np.inf
    mask = r2 < rc * rc
    sr6 = np.where(mask, (sigma * sigma / np.where(mask, r2, 1.0)) ** 3, 0.0)
    e = 4 * eps * (sr6 * sr6 - sr6)
    w = 24 * eps * (2 * sr6 * sr6 - sr6)
    return e.sum(), w.sum()


def init_ref_state(pos, box, seed_key, temp, press, dpos0, dvol_frac0, dt0,
                   eps=1.0, sigma=1.0, rc=2.5) -> RefState:
    """``seed_key``: a port key (``jrandom.key(seed)``) or a JAX key's
    words."""
    pos = np.asarray(pos, np.float64)
    box = np.asarray(box, np.float64)
    pe, vir = total_energy(pos, box, eps, sigma, rc)
    return RefState(pos=pos.copy(), box=box.copy(),
                    key=jrandom.key_data(seed_key).cpu().clone(),
                    pe=pe, virial=vir, temp=float(temp), press=float(press),
                    dpos=float(dpos0),
                    dvol=float(dvol_frac0) * float(np.prod(box)),
                    dt=float(dt0))


def _uniform(key, shape=(), lo=0.0, hi=1.0):
    return jrandom.uniform(key, shape, lo, hi).numpy().astype(np.float64)


def forces(pos, box, eps, sigma, rc):
    """Pair forces, f_i = sum_j (w(r)/r^2)(r_i - r_j) (ops/energy.forces)."""
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    r2 = (d ** 2).sum(-1)
    np.fill_diagonal(r2, np.inf)
    mask = r2 < rc * rc
    r2s = np.where(mask, r2, 1.0)
    sr6 = (sigma * sigma / r2s) ** 3
    w = 24 * eps * (2 * sr6 * sr6 - sr6)
    coef = np.where(mask, w / r2s, 0.0)
    return (coef[:, :, None] * d).sum(axis=1)


def sweep(st: RefState, kb, p2e, ppos, pvol, eps, sigma, rc,
          nstps=8, mass=1.0, trace=None):
    """One sweep of N attempts; mirrors sampler.serial move for move
    (position, volume and HMC). ``trace``, if a list, receives (move
    types (N,) 0/1/2, decisions (N,) bool) of the sweep, as the serial
    engine's trace gives them."""
    n = len(st.pos)
    mtype = np.zeros(n, np.int64)
    accs = np.zeros(n, bool)
    keys = jrandom.split(st.key, n + 1)
    st.key = keys[0]
    beta = 1.0 / (kb * st.temp)
    for a in range(n):
        kt, km = jrandom.split(keys[1 + a])
        # branch in float32 to match the serial engine's comparison bits
        u = np.float32(_uniform(kt))
        if u < np.float32(ppos):
            ki, kd, ka = jrandom.split(km, 3)
            i = int(jrandom.randint(ki, (), 0, n))
            disp = _uniform(kd, (3,), -st.dpos, st.dpos)
            new_ri = st.pos[i] + disp
            e_old, w_old = _one_particle(st.pos, st.box, i, st.pos[i],
                                         eps, sigma, rc)
            e_new, w_new = _one_particle(st.pos, st.box, i, new_ri,
                                         eps, sigma, rc)
            de, dw = e_new - e_old, w_new - w_old
            ln_u = np.log(_uniform(ka, (), 1e-38, 1.0))
            st.ntp += 1
            accs[a] = ln_u < -beta * de
            if accs[a]:
                st.pos[i] = new_ri - st.box * np.floor(new_ri / st.box)
                st.pe += de
                st.virial += dw
                st.nap += 1
        elif u < np.float32(ppos + pvol):  # f64 sum then f32 cast
            kd, ka = jrandom.split(km, 2)
            uu = float(_uniform(kd))
            vol = float(np.prod(st.box))
            dv = st.dvol * (2.0 * uu - 1.0)
            vol_new = vol + dv
            st.ntv += 1
            mtype[a] = 1
            ln_u = np.log(_uniform(ka, (), 1e-38, 1.0))
            if vol_new > 0:
                s = (vol_new / vol) ** (1.0 / 3.0)
                pos_new = st.pos * s
                box_new = st.box * s
                pe_new, vir_new = total_energy(pos_new, box_new, eps, sigma,
                                               rc)
                ln_acc = (-beta * ((pe_new - st.pe) + st.press * p2e * dv)
                          + n * np.log(vol_new / vol))
                accs[a] = ln_u < ln_acc
                if accs[a]:
                    st.pos, st.box = pos_new, box_new
                    st.pe, st.virial = pe_new, vir_new
                    st.nav += 1
        else:
            # HMC (velocity Verlet), as sampler.moves.hmc. The leapfrog
            # runs in float32 like the serial engine: the dynamics are
            # chaotic, so float64 here would diverge from its chain within
            # a few trajectories.
            kv, ka = jrandom.split(km, 2)
            f32 = np.float32
            sigma_v = f32(np.sqrt(kb * st.temp / mass))
            vel = sigma_v * jrandom.normal(kv, (n, 3)).numpy()
            ke0 = 0.5 * mass * (vel.astype(np.float64) ** 2).sum()
            dt = f32(st.dt)
            box32 = st.box.astype(f32)
            f = forces(st.pos.astype(f32), box32, eps, sigma, rc).astype(f32)
            pos = st.pos.astype(f32)
            half = f32(0.5 * dt / mass)
            for _ in range(nstps):
                vel_half = vel + half * f
                pos = pos + dt * vel_half
                f = forces(pos, box32, eps, sigma, rc).astype(f32)
                vel = vel_half + half * f
            pos = pos.astype(np.float64)
            pe_new, vir_new = total_energy(pos, st.box, eps, sigma, rc)
            ke1 = 0.5 * mass * (vel.astype(np.float64) ** 2).sum()
            dh = (pe_new - st.pe) + (ke1 - ke0)
            ln_u = np.log(_uniform(ka, (), 1e-38, 1.0))
            st.nth += 1
            mtype[a] = 2
            accs[a] = ln_u < -beta * dh
            if accs[a]:
                st.pos = pos - st.box * np.floor(pos / st.box)
                st.pe, st.virial = pe_new, vir_new
                st.nah += 1
    st.sweep += 1
    if trace is not None:
        trace.append((mtype, accs))
    return st


def adapt(st: RefState, targets=(0.5, 0.5, 0.5), factor=1.0625):
    """Mirror of sampler.adapt.adapt_step_sizes."""
    boxmin = float(np.min(st.box))
    vol = float(np.prod(st.box))

    def one(d, na, nt, target, lo, hi):
        if nt > 0:
            d = d * factor if (na / max(nt, 1)) > target else d / factor
        return float(np.clip(d, lo, hi))

    st.dpos = one(st.dpos, st.nap, st.ntp, targets[0], 1e-5 * boxmin,
                  0.25 * boxmin)
    st.dvol = one(st.dvol, st.nav, st.ntv, targets[1], 1e-8 * vol, 0.5 * vol)
    st.nap = st.ntp = st.nav = st.ntv = st.nah = st.nth = 0
    return st


def run_records(st: RefState, nrecords, mod, kb, p2e, ppos, pvol, eps=1.0,
                sigma=1.0, rc=2.5, nstps=8, mass=1.0, trace=None):
    """``nrecords`` blocks of ``mod`` sweeps with an ``adapt`` after each,
    as ``sampler/driver.py`` runs them (tests/test_golden.py's schedule).
    Returns (state, records): per record (pe, vol, nap, ntp, nav, ntv,
    nah, nth), taken before the adaptation resets the counters."""
    recs = []
    for _ in range(nrecords):
        for _ in range(mod):
            st = sweep(st, kb, p2e, ppos, pvol, eps, sigma, rc, nstps=nstps,
                       mass=mass, trace=trace)
        recs.append((st.pe, float(np.prod(st.box)), st.nap, st.ntp, st.nav,
                     st.ntv, st.nah, st.nth))
        st = adapt(st)
    return st, recs
