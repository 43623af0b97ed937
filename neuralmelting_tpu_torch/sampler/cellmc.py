"""Production engines on the cell-MC kernels (counterpart of
``neuralmelting_tpu.sampler.cellmc``): LJ and EAM.

NPT Metropolis. LJ: position sweeps run inside the B2 sweep kernel
(ops/cellmc.py ``sweep``: cell-confined checkerboard moves); volume trials
and drift-free record energetics come from the B1 pair-sum kernel
(``total``), which gives E(s x) exactly from one pass through LJ's
homogeneous scaling. EAM (``make_eam_run_fn``): stride-3 colours, one
mover per cell, and a per-slot density slab that rides with the position
slabs; the B3 sweep kernel (ops/cellmc_eam.py ``sweep``) updates it on
every acceptance, and the B4 pass (``total``) recomputes it from scratch
before the volume trials, once per volume trial at the proposed scale
(EAM has no homogeneous-scaling shortcut) and at every record. Between
records positions live in SLABS (binned, shifted frame); ``states.pos``
is synced and pe/virial refreshed at every record point. Tempering swaps
slot identities between replicas.

A chunk is a Python loop over sweeps on the device. It reads the sweep
counter once at its start and otherwise syncs with the host only at its
end, where the caller reads ``diag``: every schedule decision (volume
sweeps, rebin axis, exchange phase) is a function of that host counter.

The host draws — volume trials, the rebin shift and the exchange
uniforms — come from the JAX engines' ``jax.random`` key chain
(``ops/jrandom.py``), bit for bit: the chunk's key is
``fold_in(fold_in(key(c), seed0[0]), sweep0)`` (c = 0 for LJ without
exchange, 1 for LJ with it, 2 for EAM), each sweep splits it into
(key, kvol, kreb), volume trial v draws ``u`` and ``ln_u`` from the two
halves of ``fold_in(kvol, v)`` and the rebin its shift from ``kreb``;
exchange event e draws from ``fold_in(fold_in(xkey, e), sweep)``. The
chain depends only on ``seed0`` and the sweep counter, so a chunk walks
it on the host at its start and draws every uniform of the chunk in one
batched pass on the device (``chunk_draws``); a resumed run rederives
it. ``shard`` (the sharded runner, parallel/cellmc_sharded.py) adds the
shard index to the kernel seed word and folds it into ``kvol``, as the
JAX engines do under ``axis_name``; ``kreb`` stays shared.

Known deviations from the JAX engines (same stationary distribution):
  * the volume scale is ``pow(x, 1/3)`` (torch has no cbrt), under the
    same ``ok`` mask; it differs from ``jnp.cbrt`` by at most 1 f32 ulp
    (tests/test_torch_keychain.py measures it), and ``ln_u`` is
    ``torch.log`` of JAX's uniform, within 1 ulp of XLA's ``log``;
  * the chunk also returns the number of attempted moves (position trials
    plus volume trials), for the moves/s metric.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.ops import cellmc as CK
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.ops import jrandom, rng
from neuralmelting_tpu_torch.sampler import tempering
from neuralmelting_tpu_torch.sampler.adapt import adapt_step_sizes
from neuralmelting_tpu_torch.sampler.driver import make_record, stack_records
from neuralmelting_tpu_torch.sampler.state import box_volume

DIAG_CB_INVALID = 2          # cell width fell below rc (box shrank)
DIAG_SLAB_OVERFLOW = 4       # a cell exceeded its K slot capacity
DIAG_SHIFT_DESYNC = 16       # sharded runner: the grid shift differs
                             # across shards

# the base of each runner's key chain, as in the JAX engines
CHAIN_BASE = {("pair", False): 0, ("pair", True): 1, ("eam", False): 2,
              ("eam", True): 2}


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
    """Exact pe/virial for an LJ ensemble from its slabs (setup/rebind)."""
    r = states.temp.shape[0]
    dev = states.box.device
    params = params_of(states, geom, 1.0)     # total reads only w and L
    ones = torch.ones((r,), dtype=torch.float32, device=dev)
    sums = CK.total(geom, slabs[:3], params, pot.pot3(dev), ones)
    e, w, _ = CK.combine_sums(sums, pot.eps, ones)
    return states.replace(pe=e, virial=w)


def eam_initial_rho(geom, states, slabs, scal, series):
    """Density slab + exact pe/virial for a fresh EAM ensemble: returns
    (states, rho (R, C*K))."""
    r = states.temp.shape[0]
    dev = states.box.device
    params = params_of(states, geom, 1.0)     # total reads only L
    ones = torch.ones((r,), dtype=torch.float32, device=dev)
    st, rho = CE.total(geom, slabs[:3], params, scal, series, ones,
                       with_virial=True)
    return states.replace(pe=st[:, 0], virial=st[:, 1]), rho


# ---------------------------------------------------------------------------
# pieces shared by both engines
# ---------------------------------------------------------------------------

def _cells_cover(states, geom, rc2):
    """diag bit when some cell got narrower than the cutoff."""
    nx, ny, nz = (float(n) for n in geom.ncell)
    wmin = torch.min(torch.stack([states.box[:, 0] / nx,
                                  states.box[:, 1] / ny,
                                  states.box[:, 2] / nz]))
    return torch.where(wmin * wmin < rc2, DIAG_CB_INVALID, 0)


def chain_key(base: int, seed0, sweep0: int) -> tuple:
    """The chunk's first key, ``fold_in(fold_in(key(base), seed0[0]),
    sweep0)``, as two Python ints."""
    return jrandom.fold_in_host(jrandom.fold_in_host((0, base),
                                                     int(seed0[0])),
                                int(sweep0))


def chunk_draws(key0, nsweeps: int, nvol: int, r: int, device,
                shard=None, xkeys=()):
    """Every host draw of ``nsweeps`` sweeps from the key chain at
    ``key0``: per sweep ``key, kvol, kreb = split(key, 3)``, kvol with
    ``shard`` folded in when given. Returns (u (S, nvol, r) of the volume
    trials, ln_u (S, nvol, r) of their acceptance, du (S,) of the rebin,
    xu (E, r) the exchange uniforms of the E keys ``xkeys``). The chain
    and every draw's key are walked on the host in Python ints; the
    uniforms are one batched pass over those keys on ``device`` (``du``
    is the first word of its key's stream, as ``uniform(kreb, ())``
    draws it)."""
    k, rows = key0, []
    for _ in range(nsweeps):
        k, kvol, kreb = jrandom.split_host(k, 3)
        if shard is not None:
            kvol = jrandom.fold_in_host(kvol, shard)
        for v in range(nvol):
            rows += jrandom.split_host(jrandom.fold_in_host(kvol, v), 2)
        rows.append(kreb)
    n = len(rows)
    keys = torch.tensor(rows + list(xkeys), dtype=torch.int64).to(device)
    f = jrandom.floats01(jrandom.random_bits(keys, (r,)))
    g = f[:n].reshape(nsweeps, 2 * nvol + 1, r)
    u = jrandom.scale_uniform(g[:, 0:2 * nvol:2], 0.0, 1.0)
    ln_u = torch.log(jrandom.scale_uniform(g[:, 1:2 * nvol:2], 1e-38, 1.0))
    return (u, ln_u, jrandom.scale_uniform(g[:, 2 * nvol, 0], 0.0, 1.0),
            jrandom.scale_uniform(f[n:], 1e-38, 1.0))


def exchange_keys(xkey, sweep0: int, mod: int, nrecords: int) -> list:
    """The host keys of a chunk's exchange events: event e draws from
    ``fold_in(fold_in(xkey, e), sweep0 + (e + 1) mod)``, as the JAX
    ``propose_swaps`` does after its record block."""
    xk = [int(w) for w in xkey.tolist()]
    return [jrandom.fold_in_host(jrandom.fold_in_host(xk, e),
                                 sweep0 + (e + 1) * mod)
            for e in range(nrecords)]


def exchange_draws(xkey, sweep0: int, mod: int, nrecords: int, r: int,
                   device):
    """(nrecords, r) exchange uniforms of ``exchange_keys``, in one pass
    on ``device``."""
    keys = exchange_keys(xkey, sweep0, mod, nrecords)
    return jrandom.uniform(torch.tensor(keys, dtype=torch.int64).to(device),
                           (r,), 1e-38, 1.0)


def _vol_propose(states, u):
    """Volume trial at the uniforms ``u``: (vol, dv, ok, s) with s the
    isotropic scale."""
    vol = box_volume(states.box)
    dv = states.dvol * (2.0 * u - 1.0)
    ok = (vol + dv) > 0.0
    s = torch.where(ok, torch.pow(torch.clamp(vol + dv, min=1e-6) / vol,
                                  1.0 / 3.0), 1.0)
    return vol, dv, ok, s


def _vol_accept(states, e_old, e_new, vol, dv, ok, n, kb, p2e, ln_u):
    """NPT Metropolis of a volume trial (with the V^N Jacobian)."""
    beta = 1.0 / (kb * states.temp)
    ln_acc = (-beta * ((e_new - e_old) + states.press * p2e * dv)
              + n * torch.log(torch.where(ok, (vol + dv) / vol, 1.0)))
    return ok & (ln_u < ln_acc)


def _rescale(slabs3, sca):
    return tuple(torch.where(a < 0.1 * CG.INVALID, a * sca, a)
                 for a in slabs3)


def _rebin(geom, rebin_every, sweep_id, slabs4, count, shift, box,
           cell_tabs, du, diag, extras=()):
    """Grid-shift rebinning, one axis per rebin event, shifted by
    ``du`` of a cell; ``extras`` travel with their atoms."""
    if sweep_id % rebin_every != 0:
        return slabs4, count, shift, diag, extras
    # the axis rotates per EVENT, so rebin_every % 3 == 0 cannot pin one
    # axis
    a = (sweep_id // rebin_every) % 3
    delta = du * (0.9 / geom.ncell[a])
    out = CG.rebin_axis(geom, slabs4, count, box, delta, a,
                        cell_tab=cell_tabs[a], extras=extras)
    slabs4, count, over = out[:3]
    shift = shift.clone()
    shift[a] += delta
    diag = diag | torch.where(over, DIAG_SLAB_OVERFLOW, 0)
    return slabs4, count, shift, diag, (out[3] if extras else ())


def _chunk_runner(geom, kb, p2e, mod, nrecords, targets, factor, write_traj,
                  exchange, npress, ntemp, adapt, nvol, chain_base, shard,
                  kin_of, sweep_step, record_totals):
    """The chunk loops of both engines around their ``sweep_step``.

    ``kin_of(pot, device)``: the kernels' inputs of a chunk;
    ``sweep_step(st, sweep_id, kin, cell_tabs, seeds, draws, rtt,
    ntiles)`` advances st = (states, slabs, count, shift, diag, tried) one
    sweep, ``seeds`` (seed0[0], seed0[1] + shard) of the kernel stream and
    ``draws`` (u (nvol, R), ln_u (nvol, R), du ()) the sweep's host draws;
    ``record_totals(states, slabs, kin) -> (pe, virial, slabs)`` gives the
    drift-free energetics at a record point."""

    def block_core(st, b, sweep0, kin, cell_tabs, seeds, draws, rtt,
                   ntiles):
        u, ln_u, du, _ = draws
        for i in range(mod):
            j = b * mod + i
            st = sweep_step(st, sweep0 + j, kin, cell_tabs, seeds,
                            (u[j], ln_u[j], du[j]), rtt, ntiles)
        states, slabs, count, shift, diag, tried = st
        # drift-free energetics + position sync at the record point
        pe, w, slabs = record_totals(states, slabs, kin)
        pos = CG.unbin(geom, slabs, states.box, shift)
        states = states.replace(pe=pe, virial=w, pos=pos)
        rec = make_record(states, kb)
        if adapt:       # bench runs keep the counters accumulating instead
            states = adapt_step_sizes(states, targets=targets, factor=factor)
        frame = (states.pos, states.box.clone()) if write_traj else None
        return (states, slabs, count, shift, diag, tried), rec, frame

    def start(states, pot, seed0, xkey=None):
        r = states.temp.shape[0]
        dev = states.box.device
        rtt = pick_rt(r)
        sweep0 = int(states.sweep[0])
        diag = torch.zeros((), dtype=torch.int32, device=dev)
        tried = torch.zeros((), dtype=torch.int64, device=dev)
        xkeys = (() if xkey is None
                 else exchange_keys(xkey, sweep0, mod, nrecords))
        draws = chunk_draws(chain_key(chain_base, seed0, sweep0),
                            mod * nrecords, nvol, r, dev, shard, xkeys)
        seeds = (int(seed0[0]), int(seed0[1]) + (shard or 0))
        return (rtt, -(-r // rtt), sweep0, kin_of(pot, dev), diag, tried,
                draws, seeds)

    def finish(recs, frames):
        recs = stack_records(recs)
        if write_traj:
            frames = (torch.stack([f[0] for f in frames]),
                      torch.stack([f[1] for f in frames]))
        else:
            frames = None
        return recs, frames

    if not exchange:
        def run(states, slabs, count, shift, pot, cell_tabs, seed0):
            (rtt, ntiles, sweep0, kin, diag, tried, draws,
             seeds) = start(states, pot, seed0)
            st = (states, slabs, count, shift, diag, tried)
            recs, frames = [], []
            for b in range(nrecords):
                st, rec, frame = block_core(st, b, sweep0, kin, cell_tabs,
                                            seeds, draws, rtt, ntiles)
                recs.append(rec)
                frames.append(frame)
            states, slabs, count, shift, diag, tried = st
            recs, frames = finish(recs, frames)
            return (states, slabs, count, shift, recs, frames, diag, tried)

        return run

    if npress * ntemp <= 0:
        raise ValueError("the exchange runner needs the (P, T) grid shape")

    def run_x(states, slabs, count, shift, slot_of, xkey, pot, cell_tabs,
              t_grid, p_grid, seed0):
        (rtt, ntiles, sweep0, kin, diag, tried, draws,
         seeds) = start(states, pot, seed0, xkey)
        st = (states, slabs, count, shift, diag, tried)
        recs, frames, hist, xacc = [], [], [], []
        xu = draws[3]
        for event_idx in range(nrecords):
            st, rec, frame = block_core(st, event_idx, sweep0, kin,
                                        cell_tabs, seeds, draws, rtt,
                                        ntiles)
            states = st[0]
            hist.append(slot_of)
            states, slot_of, n_acc = tempering.exchange_event(
                states, slot_of, xu[event_idx], event_idx, npress, ntemp,
                t_grid, p_grid, kb, p2e)
            st = (states,) + st[1:]
            recs.append(rec)
            frames.append(frame)
            xacc.append(n_acc)
        states, slabs, count, shift, diag, tried = st
        recs, frames = finish(recs, frames)
        return (states, slabs, count, shift, slot_of, recs, frames,
                torch.stack(hist), torch.stack(xacc), diag, tried)

    return run_x


# ---------------------------------------------------------------------------
# LJ engine (stride-2 cells, kernels B1/B2)
# ---------------------------------------------------------------------------

def make_cellmc_run_fn(kb, p2e, geom, mod: int, nrecords: int,
                       ncyc: int = 4, nvol: int = 1,
                       targets=(0.5, 0.5, 0.5), factor: float = 1.0625,
                       write_traj: bool = False, exchange: bool = False,
                       npress: int = 0, ntemp: int = 0,
                       vol_every: int = 1, rebin_every: int = 1,
                       adapt: bool = True, shard=None):
    """Build the LJ chunk runner.

    Without exchange:
      ``run(states, slabs, count, shift, pot, cell_tabs, seed0) ->
        (states, slabs, count, shift, recs, frames, diag, tried)``
    With exchange:
      ``run(states, slabs, count, shift, slot_of, xkey, pot, cell_tabs,
        t_grid, p_grid, seed0) -> (states, slabs, count, shift, slot_of,
        recs, frames, hist, xacc, diag, tried)``

    ``slabs`` = (x, y, z, ids) leading-R, updated in place by the sweeps;
    ``count`` (R, C); ``shift`` (3,) fractional grid shift; ``cell_tabs``
    (3, C*K) per-row cell coordinates (geom_tables) on the device;
    ``seed0`` two host ints, the base key of the in-kernel threefry stream
    (the sweep counter is folded in, so chained chunks never replay it),
    and of the host draws' key chain (module docstring); ``xkey`` (2,)
    the exchange key. ``shard``: this shard's index in a sharded run
    (parallel/cellmc_sharded.py), None otherwise. ``diag`` and ``tried``
    are device tensors; reading them is the caller's sync.

    ``vol_every``/``rebin_every``: the ``nvol`` volume trials run only on
    sweeps with ``sweep % vol_every == 0``, the grid-shift rebin only where
    ``sweep % rebin_every == 0`` (deterministic, state-independent
    schedules that leave the NPT distribution invariant). ``adapt=False``
    skips the step-size adaptation at each record, so the acceptance
    counters accumulate over the chunk (the bench counts moves from them).
    """

    def sweep_step(st, sweep_id, kin, cell_tabs, seed0, draws, rtt, ntiles):
        pot, pot3 = kin
        u, ln_u, du = draws
        states, slabs, count, shift, diag, tried = st
        x, y, z, ids = slabs
        r = x.shape[0]
        dev = x.device
        diag = diag | _cells_cover(states, geom, pot.rc * pot.rc)

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
            for v in range(nvol):
                vol, dv, ok, s = _vol_propose(states, u[v])
                # params track the box accepted by an earlier trial (the
                # stencil's +-L image correction reads them)
                params = params_of(states, geom, kb)
                sums = CK.total(geom, (x, y, z), params, pot3, s)
                e_old, w_old, e_new = CK.combine_sums(sums, pot.eps, s)
                acc = _vol_accept(states, e_old, e_new, vol, dv, ok,
                                  geom.natoms, kb, p2e, ln_u[v])
                sca = torch.where(acc, s, 1.0)[:, None]
                x, y, z = _rescale((x, y, z), sca)
                states = states.replace(
                    box=states.box * sca,
                    pe=torch.where(acc, e_new, e_old),   # drift-free both
                    virial=w_old,
                    nav=states.nav + acc.to(torch.int32),
                    ntv=states.ntv + 1)
            tried = tried + nvol * r

        (x, y, z, ids), count, shift, diag, _ = _rebin(
            geom, rebin_every, sweep_id, (x, y, z, ids), count, shift,
            states.box, cell_tabs, du, diag)
        states = states.replace(sweep=states.sweep + 1)
        return (states, (x, y, z, ids), count, shift, diag, tried)

    def record_totals(states, slabs, kin):
        pot, pot3 = kin
        r = states.temp.shape[0]
        params = params_of(states, geom, kb)
        ones = torch.ones((r,), dtype=torch.float32, device=states.box.device)
        sums = CK.total(geom, slabs[:3], params, pot3, ones)
        e, w, _ = CK.combine_sums(sums, pot.eps, ones)
        return e, w, slabs

    return _chunk_runner(geom, kb, p2e, mod, nrecords, targets, factor,
                         write_traj, exchange, npress, ntemp, adapt, nvol,
                         CHAIN_BASE["pair", exchange], shard,
                         lambda pot, dev: (pot, pot.pot3(dev)), sweep_step,
                         record_totals)


# ---------------------------------------------------------------------------
# EAM engine (stride-3 cells, density slab, kernels B3/B4)
# ---------------------------------------------------------------------------

def make_eam_run_fn(kb, p2e, geom, mod: int, nrecords: int,
                    ncyc: int = 8, nvol: int = 1,
                    targets=(0.5, 0.5, 0.5), factor: float = 1.0625,
                    write_traj: bool = False, exchange: bool = False,
                    npress: int = 0, ntemp: int = 0,
                    vol_every: int = 1, rebin_every: int = 1,
                    adapt: bool = True, shard=None):
    """EAM twin of ``make_cellmc_run_fn``, with the same two signatures;
    ``pot`` is the ``EAMCheb`` (models/eam_cheb.py) and ``slabs`` =
    (x, y, z, ids, rho) leading-R, rho the per-slot density cache (exact
    at every record).

    Per sweep: the B3 sweep; on volume sweeps one s=1 B4 pass that
    refreshes pe and the density cache (the incrementally accumulated pe
    carries f32 drift since the last record), then each of the ``nvol``
    trials as a full B4 pass at the proposed scale, whose density slab an
    accepted trial keeps; the rebin carries rho. Each record runs a B4
    pass with the virial.
    """

    def sweep_step(st, sweep_id, kin, cell_tabs, seed0, draws, rtt, ntiles):
        scal, series = kin
        u, ln_u, du = draws
        states, slabs, count, shift, diag, tried = st
        x, y, z, ids, rho = slabs
        r = x.shape[0]
        dev = x.device
        diag = diag | _cells_cover(states, geom, scal[0])

        # --- position sweep (kernel B3, x, y, z, rho in place) --------
        seeds = tile_seeds(seed0, sweep_id, ntiles, dev)
        params = params_of(states, geom, kb)
        stt = CE.sweep(geom, ncyc, rtt, (x, y, z, rho), count, params, scal,
                       series, seeds)
        states = states.replace(
            pe=states.pe + stt[:, 0],
            nap=states.nap + stt[:, 1].to(torch.int32),
            ntp=states.ntp + stt[:, 2].to(torch.int32))
        tried = tried + stt[:, 2].sum().to(torch.int64)

        # --- volume trials (kernel B4, one full pass each) ------------
        if nvol > 0 and sweep_id % vol_every == 0:
            ones = torch.ones((r,), dtype=torch.float32, device=dev)
            params = params_of(states, geom, kb)
            st1, rho = CE.total(geom, (x, y, z), params, scal, series, ones,
                                with_virial=False)
            states = states.replace(pe=st1[:, 0])        # exact e_old
            for v in range(nvol):
                vol, dv, ok, s = _vol_propose(states, u[v])
                params = params_of(states, geom, kb)
                stt, rho_s = CE.total(geom, (x, y, z), params, scal, series,
                                      s, with_virial=False)
                e_new = stt[:, 0]
                acc = _vol_accept(states, states.pe, e_new, vol, dv, ok,
                                  geom.natoms, kb, p2e, ln_u[v])
                sca = torch.where(acc, s, 1.0)[:, None]
                x, y, z = _rescale((x, y, z), sca)
                rho = torch.where(acc[:, None], rho_s, rho)
                states = states.replace(
                    box=states.box * sca,
                    pe=torch.where(acc, e_new, states.pe),
                    nav=states.nav + acc.to(torch.int32),
                    ntv=states.ntv + 1)
            tried = tried + nvol * r

        (x, y, z, ids), count, shift, diag, extras = _rebin(
            geom, rebin_every, sweep_id, (x, y, z, ids), count, shift,
            states.box, cell_tabs, du, diag, extras=(rho,))
        if extras:
            (rho,) = extras
        states = states.replace(sweep=states.sweep + 1)
        return (states, (x, y, z, ids, rho), count, shift, diag, tried)

    def record_totals(states, slabs, kin):
        scal, series = kin
        r = states.temp.shape[0]
        params = params_of(states, geom, kb)
        ones = torch.ones((r,), dtype=torch.float32, device=states.box.device)
        st, rho = CE.total(geom, slabs[:3], params, scal, series, ones,
                           with_virial=True)
        return st[:, 0], st[:, 1], slabs[:4] + (rho,)

    return _chunk_runner(geom, kb, p2e, mod, nrecords, targets, factor,
                         write_traj, exchange, npress, ntemp, adapt, nvol,
                         CHAIN_BASE["eam", exchange], shard,
                         lambda pot, dev: CE.eam_pack(pot, dev)[:2],
                         sweep_step, record_totals)
