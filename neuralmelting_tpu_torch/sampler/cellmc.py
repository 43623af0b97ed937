"""Production LJ engine on the cell-MC kernels (counterpart of
``neuralmelting_tpu.sampler.cellmc``, the LJ part).

NPT Metropolis: position sweeps run inside the B2 sweep kernel
(ops/cellmc.py ``sweep``: cell-confined checkerboard moves); volume trials
and drift-free record energetics come from the B1 pair-sum kernel
(``total``), which gives E(s x) exactly from one pass through LJ's
homogeneous scaling. Between records positions live in SLABS (binned,
shifted frame); ``states.pos`` is synced and pe/virial refreshed at every
record point. Tempering swaps slot identities between replicas.

A chunk is a Python loop over sweeps on the device. It reads the sweep
counter once at its start and otherwise syncs with the host only at its
end, where the caller reads ``diag``: every schedule decision (volume
sweeps, rebin axis, exchange phase) is a function of that host counter.

Known deviations from the JAX engine (same stationary distribution):
  * host-side draws — volume trials, the rebin shift and the exchange
    uniforms — come from one ``torch.Generator`` on the run's device,
    seeded by the runner and carried across chunks, not from
    ``jax.random``: the streams differ, the distributions are the same.
    (The in-kernel sweep draws are the JAX threefry stream bit for bit.)
  * the volume scale is ``pow(x, 1/3)`` (torch has no cbrt), under the
    same ``ok`` mask;
  * the chunk also returns the number of attempted moves (position trials
    plus volume trials), for the moves/s metric.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.ops import cellmc as CK
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.ops import rng
from neuralmelting_tpu_torch.sampler import tempering
from neuralmelting_tpu_torch.sampler.adapt import adapt_step_sizes
from neuralmelting_tpu_torch.sampler.driver import make_record, stack_records
from neuralmelting_tpu_torch.sampler.state import box_volume

DIAG_CB_INVALID = 2          # cell width fell below rc (box shrank)
DIAG_SLAB_OVERFLOW = 4       # a cell exceeded its K slot capacity


def default_ncyc(geom) -> int:
    """Checkerboard cycles per sweep so attempted moves ~= natoms
    (min(cnt, J) movers per cell per colour step)."""
    occ = max(1, geom.natoms // geom.ncells)
    per_cycle = geom.ncells * min(geom.nsub, occ)
    return max(1, int(round(geom.natoms / per_cycle)))


def pick_rt(r: int) -> int:
    """The JAX lane-tile width for R replicas. The card has no lane tiles,
    but the sweep's random stream is keyed per tile of rt replicas, so
    rt stays part of the stream."""
    return r if r <= 128 else 128


def build_slabs(geom, states, shift):
    """Bin an ensemble's positions -> ((x, y, z, ids), count, overflow),
    all leading-R."""
    x, y, z, ids, count, over = CG.bin_initial(geom, states.pos, states.box,
                                               shift)
    return (x, y, z, ids), count, over


def params_of(states, geom, kb):
    """(R, 8) rows [beta, dpos_eff, wx, wy, wz, Lx, Ly, Lz]; the trial
    displacement is capped at 0.45 of the narrowest cell width."""
    nx, ny, nz = (float(n) for n in geom.ncell)
    wvec = torch.stack([states.box[:, 0] / nx, states.box[:, 1] / ny,
                        states.box[:, 2] / nz], dim=1)
    wmin = torch.min(wvec, dim=-1).values
    dpos_eff = torch.minimum(states.dpos, 0.45 * wmin)
    return torch.stack([1.0 / (kb * states.temp), dpos_eff,
                        wvec[:, 0], wvec[:, 1], wvec[:, 2],
                        states.box[:, 0], states.box[:, 1],
                        states.box[:, 2]], dim=1).contiguous()


def tile_seeds(seed0, sweep_id: int, ntiles: int, device):
    """Per-tile threefry keys (seed0[0] + sweep*ntiles + tile, seed0[1]),
    int32 wrapping, as (ntiles, 2) int32 on ``device``."""
    base = (int(seed0[0]) + sweep_id * ntiles) & 0xFFFFFFFF
    k0 = torch.arange(ntiles, dtype=torch.int64, device=device) + base
    k1 = torch.full((ntiles,), int(seed0[1]) & 0xFFFFFFFF,
                    dtype=torch.int64, device=device)
    return torch.stack([rng.to_int32(k0), rng.to_int32(k1)], dim=1)


def refresh_energies(geom, states, slabs, pot):
    """Exact pe/virial for an ensemble from its slabs (setup/rebind)."""
    r = states.temp.shape[0]
    dev = states.box.device
    params = params_of(states, geom, 1.0)     # total reads only w and L
    ones = torch.ones((r,), dtype=torch.float32, device=dev)
    sums = CK.total(geom, slabs[:3], params, pot.pot3(dev), ones)
    e, w, _ = CK.combine_sums(sums, pot.eps, ones)
    return states.replace(pe=e, virial=w)


def make_cellmc_run_fn(kb, p2e, geom, mod: int, nrecords: int,
                       ncyc: int = 4, nvol: int = 1,
                       targets=(0.5, 0.5, 0.5), factor: float = 1.0625,
                       write_traj: bool = False, exchange: bool = False,
                       npress: int = 0, ntemp: int = 0,
                       vol_every: int = 1, rebin_every: int = 1):
    """Build the chunk runner.

    Without exchange:
      ``run(states, slabs, count, shift, pot, cell_tabs, seed0, gen) ->
        (states, slabs, count, shift, recs, frames, diag, tried)``
    With exchange:
      ``run(states, slabs, count, shift, slot_of, gen, pot, cell_tabs,
        t_grid, p_grid, seed0) -> (states, slabs, count, shift, slot_of,
        recs, frames, hist, xacc, diag, tried)``

    ``slabs`` = (x, y, z, ids) leading-R, updated in place by the sweeps;
    ``count`` (R, C); ``shift`` (3,) fractional grid shift; ``cell_tabs``
    (3, C*K) per-row cell coordinates (geom_tables) on the device;
    ``seed0`` two host ints, the base key of the in-kernel threefry stream
    (the sweep counter is folded in, so chained chunks never replay it);
    ``gen`` the torch.Generator of the host draws. ``diag`` and ``tried``
    are device tensors; reading them is the caller's sync.

    ``vol_every``/``rebin_every``: the ``nvol`` volume trials run only on
    sweeps with ``sweep % vol_every == 0``, the grid-shift rebin only where
    ``sweep % rebin_every == 0`` (deterministic, state-independent
    schedules that leave the NPT distribution invariant).
    """
    nxf, nyf, nzf = (float(n) for n in geom.ncell)
    deltas = [0.9 / n for n in geom.ncell]

    def sweep_step(st, sweep_id, pot, pot3, cell_tabs, seed0, gen, rtt,
                   ntiles):
        states, slabs, count, shift, diag, tried = st
        x, y, z, ids = slabs
        r = x.shape[0]
        dev = x.device

        # geometry validity: every cell must still cover rc
        wmin = torch.min(torch.stack([states.box[:, 0] / nxf,
                                      states.box[:, 1] / nyf,
                                      states.box[:, 2] / nzf]))
        diag = diag | torch.where(wmin < pot.rc, DIAG_CB_INVALID, 0)

        # --- position sweep (kernel B2, in place) -------------------
        seeds = tile_seeds(seed0, sweep_id, ntiles, dev)
        params = params_of(states, geom, kb)
        stt = CK.sweep(geom, ncyc, rtt, (x, y, z), count, params, pot3,
                       seeds)
        states = states.replace(
            pe=states.pe + stt[:, 0],
            nap=states.nap + stt[:, 1].to(torch.int32),
            ntp=states.ntp + stt[:, 2].to(torch.int32))
        tried = tried + stt[:, 2].sum().to(torch.int64)

        # --- volume trials (kernel B1; E(s x) exact) -----------------
        if nvol > 0 and sweep_id % vol_every == 0:
            n = geom.natoms
            for _ in range(nvol):
                u = torch.rand((r,), generator=gen, device=dev)
                vol = box_volume(states.box)
                dv = states.dvol * (2.0 * u - 1.0)
                ok = (vol + dv) > 0.0
                s = torch.where(
                    ok, torch.pow(torch.clamp(vol + dv, min=1e-6) / vol,
                                  1.0 / 3.0), 1.0)
                # params track the box accepted by an earlier trial (the
                # stencil's +-L image correction reads them)
                params = params_of(states, geom, kb)
                sums = CK.total(geom, (x, y, z), params, pot3, s)
                e_old, w_old, e_new = CK.combine_sums(sums, pot.eps, s)
                beta = 1.0 / (kb * states.temp)
                ln_acc = (-beta * ((e_new - e_old)
                                   + states.press * p2e * dv)
                          + n * torch.log(torch.where(ok, (vol + dv) / vol,
                                                      1.0)))
                # 1 - U[0,1) lies in (0, 1]: log-safe
                ln_u = torch.log(1.0 - torch.rand((r,), generator=gen,
                                                  device=dev))
                acc = ok & (ln_u < ln_acc)
                sca = torch.where(acc, s, 1.0)[:, None]
                x = torch.where(x < 0.1 * CG.INVALID, x * sca, x)
                y = torch.where(y < 0.1 * CG.INVALID, y * sca, y)
                z = torch.where(z < 0.1 * CG.INVALID, z * sca, z)
                states = states.replace(
                    box=states.box * sca,
                    pe=torch.where(acc, e_new, e_old),   # drift-free both
                    virial=w_old,
                    nav=states.nav + acc.to(torch.int32),
                    ntv=states.ntv + 1)
            tried = tried + nvol * r

        # --- grid-shift rebinning (one axis per rebin event) ---------
        if sweep_id % rebin_every == 0:
            # the axis rotates per EVENT, so rebin_every % 3 == 0 cannot
            # pin one axis
            a = (sweep_id // rebin_every) % 3
            du = torch.rand((), generator=gen, device=dev)
            delta = du * deltas[a]
            (x, y, z, ids), count, over = CG.rebin_axis(
                geom, (x, y, z, ids), count, states.box, delta, a,
                cell_tab=cell_tabs[a])
            shift = shift.clone()
            shift[a] += delta
            diag = diag | torch.where(over, DIAG_SLAB_OVERFLOW, 0)

        states = states.replace(sweep=states.sweep + 1)
        return (states, (x, y, z, ids), count, shift, diag, tried)

    def block_core(st, sweep0, pot, pot3, cell_tabs, seed0, gen, rtt,
                   ntiles):
        for i in range(mod):
            st = sweep_step(st, sweep0 + i, pot, pot3, cell_tabs, seed0,
                            gen, rtt, ntiles)
        states, slabs, count, shift, diag, tried = st
        # drift-free energetics + position sync at the record point
        r = states.temp.shape[0]
        dev = states.box.device
        params = params_of(states, geom, kb)
        ones = torch.ones((r,), dtype=torch.float32, device=dev)
        sums = CK.total(geom, slabs[:3], params, pot3, ones)
        e, w, _ = CK.combine_sums(sums, pot.eps, ones)
        pos = CG.unbin(geom, slabs, states.box, shift)
        states = states.replace(pe=e, virial=w, pos=pos)
        rec = make_record(states, kb)
        states = adapt_step_sizes(states, targets=targets, factor=factor)
        frame = (states.pos, states.box.clone()) if write_traj else None
        return (states, slabs, count, shift, diag, tried), rec, frame

    def start(states, pot):
        r = states.temp.shape[0]
        dev = states.box.device
        rtt = pick_rt(r)
        sweep0 = int(states.sweep[0])
        diag = torch.zeros((), dtype=torch.int32, device=dev)
        tried = torch.zeros((), dtype=torch.int64, device=dev)
        return rtt, -(-r // rtt), sweep0, pot.pot3(dev), diag, tried

    def finish(recs, frames):
        recs = stack_records(recs)
        if write_traj:
            frames = (torch.stack([f[0] for f in frames]),
                      torch.stack([f[1] for f in frames]))
        else:
            frames = None
        return recs, frames

    if not exchange:
        def run(states, slabs, count, shift, pot, cell_tabs, seed0, gen):
            rtt, ntiles, sweep0, pot3, diag, tried = start(states, pot)
            st = (states, slabs, count, shift, diag, tried)
            recs, frames = [], []
            for b in range(nrecords):
                st, rec, frame = block_core(st, sweep0 + b * mod, pot, pot3,
                                            cell_tabs, seed0, gen, rtt,
                                            ntiles)
                recs.append(rec)
                frames.append(frame)
            states, slabs, count, shift, diag, tried = st
            recs, frames = finish(recs, frames)
            return (states, slabs, count, shift, recs, frames, diag, tried)

        return run

    if npress * ntemp <= 0:
        raise ValueError("the exchange runner needs the (P, T) grid shape")

    def run_x(states, slabs, count, shift, slot_of, gen, pot, cell_tabs,
              t_grid, p_grid, seed0):
        rtt, ntiles, sweep0, pot3, diag, tried = start(states, pot)
        st = (states, slabs, count, shift, diag, tried)
        recs, frames, hist, xacc = [], [], [], []
        r = states.temp.shape[0]
        for event_idx in range(nrecords):
            st, rec, frame = block_core(st, sweep0 + event_idx * mod, pot,
                                        pot3, cell_tabs, seed0, gen, rtt,
                                        ntiles)
            states = st[0]
            hist.append(slot_of)
            u = 1.0 - torch.rand((r,), generator=gen, device=slot_of.device)
            states, slot_of, n_acc = tempering.exchange_event(
                states, slot_of, u, event_idx, npress, ntemp, t_grid,
                p_grid, kb, p2e)
            st = (states,) + st[1:]
            recs.append(rec)
            frames.append(frame)
            xacc.append(n_acc)
        states, slabs, count, shift, diag, tried = st
        recs, frames = finish(recs, frames)
        return (states, slabs, count, shift, slot_of, recs, frames,
                torch.stack(hist), torch.stack(xacc), diag, tried)

    return run_x
