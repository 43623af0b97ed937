"""Checkerboard NPT sweep over neighbour lists, batched over replicas
(counterpart of ``neuralmelting_tpu.sampler.checkerboard``).

One sweep = ``npasses`` passes + ``nvol`` volume trials (+ optional HMC).
Each pass, for every replica at once:
  1. a random fractional grid shift and a random colour order,
  2. the particles binned into cells (one stable sort),
  3. for each of the stride^3 colours in that order: one random particle
     per occupied active cell, a displacement, the batched dE from the
     neighbour list, Metropolis accept/reject in parallel (exact: see
     ops/cells.py), and the accepted moves added into the positions.

Every draw is the JAX engine's, bit for bit, from the replica's pass key
(``ops/jrandom.py``): the split into (shift, order, colour) keys, the
shift, ``permutation`` of the colours, one key a colour split into
(pick, displacement, acceptance), ``uniform`` picks, displacements in
[-dpos, dpos) with their contracted multiply-add, and ln u. A pass draws
all its colours' numbers before its first substep; none depends on the
state. Energies take torch's summation order, so a decision can differ
from the JAX engine's only where its margin is at f32 rounding.

The caller owns the neighbour-list discipline (parallel/ensemble.py
rebuilds between passes); the functions here run on CPU and CUDA tensors
alike and copy nothing from the host to the device, so a CUDA graph can
capture a pass or a tail. On CUDA tensors a pass's colour substeps run
through ``torch.compile`` (``compiled_colour_step``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neuralmelting_tpu_torch.ops import cells as cells_ops
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.ops import neighbors as NB
from neuralmelting_tpu_torch.ops import potential_ops as PO
from neuralmelting_tpu_torch.sampler import moves

# diagnostic bit flags
DIAG_NL_OVERFLOW = 1
DIAG_CB_INVALID = 2
DIAG_NL_STALE = 8  # an energy was evaluated while the skin invariant held
                   # no longer (only HMC trajectories can do this)

_SQ3 = 3.0 ** 0.5  # max |displacement| per move = sqrt(3) * dpos


def nl_backend(pops: PO.PotentialOps, nl: NB.NeighborList
               ) -> moves.EnergyBackend:
    """The batched appliers' energies from the lists ``nl``."""
    return moves.EnergyBackend(
        total=lambda pot, pos, box: pops.total(pot, pos, box, nl),
        delta_move=lambda pot, pos, box, i, ri: NB.delta_move_single(
            pot, pos, box, nl, i, ri),
        forces=lambda pot, pos, box: pops.forces(pot, pos, box, nl))


def default_npasses(natoms: int, cellcfg: cells_ops.CellConfig) -> int:
    """Passes per sweep so one sweep attempts ~N moves."""
    return max(1, int(np.ceil(natoms / cellcfg.ncells_total)))


def div(x, d):
    """x / d for a host number d, by a true division on every device (a
    CUDA tensor divided by a host number is multiplied by its
    reciprocal instead)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def cb_dpos_margin(pops, pot, cellcfg: cells_ops.CellConfig, box):
    """Checkerboard-independence margin (R,): dpos may be at most half of
    (stride-1)*min(cell width) - interaction range. <=0 means the grid no
    longer supports exact parallel acceptance (DIAG_CB_INVALID)."""
    n0, n1, n2 = (int(c) for c in cellcfg.ncell)
    w_min = torch.minimum(div(box[..., 0], n0),
                          torch.minimum(div(box[..., 1], n1),
                                        div(box[..., 2], n2)))
    return (cellcfg.stride - 1) * w_min - pops.range_factor * pot.rc


def pass_floats(pkey, ncolors: int, m: int):
    """``pass_draws`` with the displacements as the floats in [0, 1) that
    ``scale_disp`` scales: a block of sweeps' draws made before their
    step sizes are known."""
    ksh, kperm, kcol = jrandom.split(pkey, 3).unbind(-2)
    kpick, kdisp, kacc = jrandom.split(jrandom.split(kcol, ncolors),
                                       3).unbind(-2)
    return (jrandom.uniform(ksh, (3,)), jrandom.permutation(kperm, ncolors),
            jrandom.uniform(kpick, (m,)),
            jrandom.floats01(jrandom.random_bits(kdisp, (m, 3))),
            torch.log(jrandom.uniform(kacc, (m,), 1e-38, 1.0)))


def scale_disp(f, dpos_eff):
    """Displacement floats in [0, 1) (R, ...) as ``uniform(kdisp, ...,
    -dpos_eff, dpos_eff)`` gives them, dpos_eff (R,)."""
    d = dpos_eff.reshape((-1,) + (1,) * (f.dim() - 1))
    return jrandom.scale_uniform(f, -d, d)


# bytes of state-free draws one stage makes at most (``draw_spans``)
DRAW_BYTES = 1 << 28


def draw_spans(mod: int, movers: int) -> list:
    """The spans of sweeps into which a record block of ``mod`` sweeps
    cuts its state-free draws, ``movers`` trials a sweep over the
    ensemble each drawing five f32 numbers: as few as keep a span's draws
    within DRAW_BYTES."""
    span = max(1, min(mod, DRAW_BYTES // max(1, 20 * movers)))
    return [min(span, mod - s) for s in range(0, mod, span)]


def pass_draws(pkey, ncolors: int, m: int, dpos_eff):
    """A pass's draws from its keys (R, 2), or several passes' from (R, P,
    2): shift (..., 3), colour order (..., C), pick uniforms (..., C, M),
    displacements (..., C, M, 3) in [-dpos_eff, dpos_eff) (dpos_eff (R,))
    and ln u (..., C, M)."""
    shift, order, u, f, ln_u = pass_floats(pkey, ncolors, m)
    return shift, order, u, scale_disp(f, dpos_eff), ln_u


def pick_movers(table, colors, count, start, sorted_ids, u):
    """One random particle of every active cell of the colours ``colors``
    (R, ...): (ids (R, ..., M), valid (R, ..., M) where the cell is
    occupied; an empty cell gives some other particle, never moved), from
    the uniforms ``u`` (R, ..., M) and the pass's binning."""
    r = colors.shape[0]
    cells = table[colors]                                   # (R, ..., M)
    cnt = count.gather(1, cells.reshape(r, -1)).reshape(cells.shape)
    st0 = start.gather(1, cells.reshape(r, -1)).reshape(cells.shape)
    pick = torch.minimum((u * cnt).to(torch.int32),
                         torch.clamp(cnt - 1, min=0))
    n = sorted_ids.shape[1]
    slot = torch.clamp(st0 + pick, 0, n - 1).reshape(r, -1).long()
    return sorted_ids.gather(1, slot).reshape(cells.shape), cnt > 0


def colour_step(pops, pot, pos, box, nl, aux, pid, ok, disp, ln_u, nbeta,
                pe, vir):
    """One colour substep of a pass: movers ``pid`` (R, M) (``ok`` where
    their cell is occupied) displaced by ``disp`` (R, M, 3), decided on
    ``ln_u`` (R, M) against ``nbeta`` (R, 1) dE; the accepted moves added
    into the positions, the potential cache, pe and the virial. Returns
    (pos, aux, pe, vir, acc, de)."""
    pid3 = pid[..., None].expand(-1, -1, 3)
    old_r = pos.gather(1, pid3)
    new_r = old_r + disp
    de, dw, payload = pops.delta(pot, pos, box, nl, aux, pid, new_r)
    acc = ok & (ln_u < nbeta * de)
    delta = torch.where(acc[..., None],
                        moves.wrap_pos(new_r, box[:, None, :]) - old_r, 0.0)
    # duplicate pids only occur for empty cells (delta == 0): an add is
    # exact in any order where a set would race
    pos = pos.scatter_add(1, pid3, delta)
    aux = pops.apply_accept(aux, pid, acc, payload)
    # pe and virial in the JAX engine's order: one colour at a time
    pe = pe + torch.where(acc, de, 0.0).sum(-1)
    vir = vir + torch.where(acc, dw, 0.0).sum(-1)
    return pos, aux, pe, vir, acc, de


_COMPILED = []


def compiled_colour_step():
    """``colour_step`` through ``torch.compile``, for CUDA tensors: the ~60
    (LJ) to ~120 (EAM) small device operations of a substep fuse into a
    few kernels (compiled at the first call with each potential and
    shape, in this process, with no pool of compile workers; Dynamo's
    limit of compiled variants of one function is raised to 64 for
    them). Its roundings may differ from the eager substep's by an ulp (a
    contracted multiply-add, a reduction order)."""
    if not _COMPILED:
        import torch._dynamo.config as dynamo_config
        dynamo_config.recompile_limit = max(dynamo_config.recompile_limit,
                                            64)
        _COMPILED.append(torch.compile(
            colour_step, fullgraph=True, dynamic=False,
            options={"compile_threads": 1}))
    return _COMPILED[0]


def make_cb_pass_fn(kb, cellcfg: cells_ops.CellConfig, style: str = "pair",
                    compiled: bool = True):
    """Build ``pass_fn(pot, table, states, nl, aux, dpos_eff, pkey) ->
    (states, aux)``: ONE checkerboard pass of every replica (each particle
    trialled at most once). ``table`` is ``cellcfg.active_table`` as an
    int64 tensor on the states' device, ``dpos_eff`` (R,), ``pkey`` (R, 2).
    The list must satisfy rc + 2 (maxdisp + sqrt(3) dpos_eff) <= rlist
    min(s) on entry, so every in-pass trial energy is exact. Returns a new
    state; the input's tensors are not changed. ``draws``: the pass's
    ``pass_draws`` made beforehand (then ``pkey`` is not read). With a
    list ``trace``, the pass appends each colour's (valid, accepted, ln u
    - weight): a decision's margin. On CUDA tensors the colour substeps
    run through ``compiled_colour_step`` unless ``compiled`` is false."""
    pops = PO.ops_for_style(style)
    ncolors = cellcfg.ncolors
    m = cellcfg.cells_per_color
    ncell = cellcfg.ncell

    def one_pass(pot, table, states, nl, aux, dpos_eff, pkey, draws=None,
                 trace=None):
        if draws is None:
            draws = pass_draws(pkey, ncolors, m, dpos_eff)
        shift, order, u, disp, ln_u = draws
        sorted_ids, start, count = cells_ops.bin_particles(
            states.pos, states.box, ncell, shift)
        # the binning is frozen for the pass: every colour's movers at once
        pids, valid = pick_movers(table, order, count, start, sorted_ids, u)
        nbeta = -(1.0 / (kb * states.temp))[:, None]
        step = compiled_colour_step() \
            if compiled and states.pos.is_cuda else colour_step
        pos, pe, vir = states.pos, states.pe, states.virial
        accs = []
        for c in range(ncolors):
            pos, aux, pe, vir, acc, de = step(
                pops, pot, pos, states.box, nl, aux, pids[:, c],
                valid[:, c], disp[:, c], ln_u[:, c], nbeta, pe, vir)
            if trace is not None:
                trace.append((valid[:, c], acc, ln_u[:, c] - nbeta * de))
            accs.append(acc)
        # integer counts: any order is exact
        nap = states.nap + torch.stack(accs, 1).sum((1, 2),
                                                    dtype=torch.int32)
        ntp = states.ntp + valid.sum((1, 2), dtype=torch.int32)
        return states.replace(pos=pos, pe=pe, virial=vir, nap=nap,
                              ntp=ntp), aux

    return one_pass


def make_cb_tail_fn(kb, p2e, nvol: int = 1, nhmc: int = 0,
                    nstps: int = 16, mass: float = 1.0,
                    style: str = "pair"):
    """Build ``tail(pot, states, nl, aux, kvol, khmc, vdraws=None) ->
    (states, aux)``: the whole-configuration moves ending a sweep (volume
    trials, then HMC), every replica on its own keys (R, 2); ``vdraws``,
    the volume trials' (2u - 1, ln u) (R, nvol) made beforehand from
    ``kvol`` (``moves.volume_draws``), then ``kvol`` is not read. The
    caller must ensure the list covers the worst volume shrink and the
    HMC drift budget (see parallel/ensemble.py). Returns a new state, and for EAM the
    density cache rebuilt from scratch after those moves."""
    pops = PO.ops_for_style(style)

    def tail(pot, states, nl, aux, kvol, khmc, vdraws=None):
        backend = nl_backend(pops, nl)
        st = dataclasses.replace(states)
        nbeta = -(1.0 / (kb * st.temp))
        n = st.pos.shape[-2]
        for v in range(nvol):
            if vdraws is None:
                v2u, ln_u = moves.volume_draws(jrandom.fold_in(kvol, v))
            else:
                v2u, ln_u = vdraws[0][:, v], vdraws[1][:, v]
            acc, _ = moves.volume(pot, p2e, backend, st, nbeta, v2u, ln_u)
            st.nav = st.nav + acc.to(torch.int32)
            st.ntv = st.ntv + 1
        for h in range(nhmc):
            normals, ln_u = moves.hmc_draws(jrandom.fold_in(khmc, h), n)
            acc, _ = moves.hmc(pot, kb, backend, st, nbeta, normals, ln_u,
                               nstps, mass)
            st.nah = st.nah + acc.to(torch.int32)
            st.nth = st.nth + 1
        if (nvol or nhmc) and pops.kind != "pair":
            # whole-configuration moves invalidate the density cache
            aux = pops.init_aux(pot, st.pos, st.box, nl)
        return st, aux

    return tail


def make_cb_sweep_fn(kb, p2e, cellcfg: cells_ops.CellConfig,
                     npasses: int = 1, nvol: int = 1, nhmc: int = 0,
                     nstps: int = 16, mass: float = 1.0,
                     style: str = "pair"):
    """Build ``sweep(pot, table, states, nl, aux) -> (states, aux, diag)``
    — npasses passes + the tail as one unit, checking nothing between
    passes. The production runner (parallel/ensemble.py) drives pass and
    tail separately with staleness checks and rebuilds; use this form
    only where the skin covers a whole sweep."""
    pops = PO.ops_for_style(style)
    one_pass = make_cb_pass_fn(kb, cellcfg, style)
    tail = make_cb_tail_fn(kb, p2e, nvol, nhmc, nstps, mass, style)

    def sweep(pot, table, states, nl, aux):
        key, kpass, kvol, khmc = jrandom.split(states.key, 4).unbind(-2)
        states = states.replace(key=key)
        margin = cb_dpos_margin(pops, pot, cellcfg, states.box)
        dpos_eff = torch.minimum(states.dpos, 0.5 * margin)
        diag = torch.where(margin <= 0.0, DIAG_CB_INVALID, 0).to(torch.int32)
        for pk in jrandom.split(kpass, npasses).unbind(-2):
            states, aux = one_pass(pot, table, states, nl, aux, dpos_eff, pk)
        states, aux = tail(pot, states, nl, aux, kvol, khmc)
        diag = diag | torch.where(nl.overflow, DIAG_NL_OVERFLOW,
                                  0).to(torch.int32)
        return states.replace(sweep=states.sweep + 1), aux, diag

    return sweep
