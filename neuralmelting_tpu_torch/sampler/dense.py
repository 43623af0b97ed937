"""The dense engine: neighbour-free checkerboard NPT sampling of pair
potentials (counterpart of ``neuralmelting_tpu.sampler.dense``).

The same Markov chain as sampler/checkerboard.py, with another way to
the energies: each trial energy is taken against every atom and its
periodic ghost images (ops/ghosts.py, ops/dense_delta.py), with no
neighbour list. LJ (pair potentials) only, in one process, as in the JAX
package; selectable for production LJ runs (``runner.setup_run(...,
engine="dense")``, ``remcmc --engine dense``).

Every draw is the JAX engine's, bit for bit, from the replicas' keys
(``ops/jrandom.py``): a pass splits its key into (shift, colour) keys and
the colour key into one key a colour, in colour order, each split into
(pick, displacement, acceptance); a volume trial's (u, ln u) come from
``fold_in(kvol, v)``. Positions live in the ghost map between records:
``states.pos`` is synced (wrapped) at records, as in the JAX engine.

Ghost coverage (ADVICE.md r1 of the JAX package): before every pass and
before the volume trials, any replica whose images would not survive the
coming stage (one move of sqrt(3) dpos_eff a pass; the worst shrink of
the volume trials) rebuilds the ghosts of ALL replicas, as the JAX
engine's ``jnp.any(stale)``; dpos_eff is clamped so that a fresh rebuild
always buys one legal pass. Where the JAX engine decides that in a
``lax.cond`` on the device, the host reads the decision here: one sync
before every pass and one before the volume trials (``COUNTS``).

The draws that do not depend on the state (the keys' chain, every
pass's draws, the volume trials') are made for a span of sweeps at once
(``checkerboard.draw_spans``), in one stage (``block_draws``). A sweep
is four kinds of stage, each a function of tensors: the head (dpos_eff,
the passes' displacements scaled by it, the first rebuild decision), the
ghost rebuild, a pass (ending with the next two rebuild decisions) and
the tail (the volume trials and the overflow bit). On the
card each stage is replayed from a CUDA graph captured from the same
function at its first call (``parallel.ensemble.make_stage``; one graph a
stage and input shape), the colour substeps and the energy row sums
compiled by ``torch.compile``: the same kernels in the same order, so
the same bits as running the stages eagerly (chip_smoke holds them to
it). On the CPU the stages run eagerly.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.ops import cells as cells_ops
from neuralmelting_tpu_torch.ops import dense_delta as DD
from neuralmelting_tpu_torch.ops import ghosts as GH
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.parallel.ensemble import make_stage
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler import moves, tempering
from neuralmelting_tpu_torch.sampler.adapt import adapt_step_sizes
from neuralmelting_tpu_torch.sampler.driver import make_record, stack_records
from neuralmelting_tpu_torch.sampler.state import box_volume

DIAG_GHOST_OVERFLOW = 4

# host-side counts since the last reset_counts(): sweeps, passes, host
# syncs (rebuild decisions), global ghost rebuilds, CUDA graph replays
COUNTS = {"sweeps": 0, "passes": 0, "syncs": 0, "rebuilds": 0,
          "replays": 0}

_SQ3 = 3.0 ** 0.5


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def dense_dpos_margin(pot, cellcfg: cells_ops.CellConfig, box):
    """Checkerboard-independence margin (R,) (pair range only):
    (stride - 1) min(cell width) - rc."""
    n0, n1, n2 = (int(c) for c in cellcfg.ncell)
    w_min = torch.minimum(CB.div(box[..., 0], n0),
                          torch.minimum(CB.div(box[..., 1], n1),
                                        CB.div(box[..., 2], n2)))
    return (cellcfg.stride - 1) * w_min - pot.rc


def block_draws(key, span: int, npasses: int, nvol: int, ncolors: int,
                m: int):
    """The draws of ``span`` sweeps that do not depend on the state, from
    the replicas' keys (R, 2), as the JAX run function makes them sweep by
    sweep: a sweep splits the key in (key, pass key, volume key), pass p
    draws from ``fold_in(pass key, p)`` (``pass_draws``), volume trial v
    from ``fold_in(volume key, v)`` (``moves.volume_draws``). Returns (the
    key after the last sweep, every sweep's volume steps 2u - 1 (R, span,
    nvol), and for every sweep and pass (R, span, npasses, ...): the
    shift, the pick uniforms, the displacements' floats in [0, 1) before
    ``checkerboard.scale_disp``, ln u; then the volume trials' ln u (R,
    span, nvol))."""
    kpass, kvol = [], []
    for _ in range(span):
        key, kp, kv = jrandom.split(key, 3).unbind(-2)
        kpass.append(kp)
        kvol.append(kv)
    pkeys = jrandom.fold_in(torch.stack(kpass, 1)[:, :, None, :],
                            torch.arange(npasses, device=key.device))
    v2u, vln_u = moves.volume_draws(jrandom.fold_in(
        torch.stack(kvol, 1)[:, :, None, :],
        torch.arange(nvol, device=key.device)))
    ksh, kpick, kdisp, kacc = _pass_keys(pkeys, ncolors)
    return (key, v2u, jrandom.uniform(ksh, (3,)),
            jrandom.uniform(kpick, (m,)),
            jrandom.floats01(jrandom.random_bits(kdisp, (m, 3))),
            torch.log(jrandom.uniform(kacc, (m,), 1e-38, 1.0)), vln_u)


def _pass_keys(pkey, ncolors: int):
    """A pass key's (shift key, and each colour's pick, displacement and
    acceptance keys (..., C, 2))."""
    ksh, kcol = jrandom.split(pkey, 2).unbind(-2)
    return (ksh,) + jrandom.split(jrandom.split(kcol, ncolors),
                                  3).unbind(-2)


def pass_draws(pkey, ncolors: int, m: int, dpos_eff):
    """A pass's draws from its keys (R, 2), or several passes' from (R, P,
    2): shift (..., 3), pick uniforms (..., C, M), displacements (..., C,
    M, 3) in [-dpos_eff, dpos_eff) (dpos_eff (R,)) and ln u (..., C, M)."""
    ksh, kpick, kdisp, kacc = _pass_keys(pkey, ncolors)
    d = dpos_eff.reshape((-1,) + (1,) * (pkey.dim() + 1))
    return (jrandom.uniform(ksh, (3,)), jrandom.uniform(kpick, (m,)),
            jrandom.uniform(kdisp, (m, 3), -d, d),
            torch.log(jrandom.uniform(kacc, (m,), 1e-38, 1.0)))


def colour_step(pot, pos_ext, parent_ext, slots_of, pid, ok, disp, ln_u,
                nbeta, pe):
    """One colour substep of a pass: movers ``pid`` (R, M) (``ok`` where
    their cell is occupied) displaced by ``disp`` (R, M, 3), decided on
    ``ln_u`` (R, M) against ``nbeta`` (R, 1) dE; the accepted moves added
    into their rows and ghost rows, and pe. Returns (pos_ext, pe, acc)."""
    pid = pid.long()
    old_r = pos_ext.gather(1, pid[..., None].expand(-1, -1, 3))
    new_r = old_r + disp
    de, _ = DD.delta_rows(pot, pos_ext, parent_ext, pid, old_r, new_r)
    acc = ok & (ln_u < nbeta * de)
    delta = torch.where(acc[..., None], disp, 0.0)
    pos_ext = GH.move_rows(pos_ext, slots_of, pid, delta)
    return pos_ext, pe + torch.where(acc, de, 0.0).sum(-1), acc


def make_dense_pass_fn(kb, cellcfg: cells_ops.CellConfig):
    """Build ``pass_fn(pot, table, states, gm, dpos_eff, pkey) -> (states,
    gm)``: ONE checkerboard pass of every replica on the ghost-extended
    set, the colours in order. ``table`` is ``cellcfg.active_table`` as an
    int64 tensor on the states' device, ``dpos_eff`` (R,), ``pkey`` (R,
    2). ``states.pos`` is not maintained: ``gm.pos_ext[:, :N]`` (unwrapped)
    is, and the run function syncs it at records. On entry the ghosts
    must satisfy rc + 2 (maxdisp + sqrt(3) dpos_eff) <= shell, so every
    trial energy is exact. ``draws``: the pass's ``pass_draws`` made
    beforehand (then ``pkey`` is not read). On CUDA tensors the colour
    substeps run through ``torch.compile`` (``dense_delta.compiled``): both
    sides' row sums fuse into one kernel, with the pick gather before it
    and the scatter after it in a few more; its roundings may differ from
    the eager substep's by an ulp (a contracted multiply-add, a reduction
    order)."""
    ncolors = cellcfg.ncolors
    m = cellcfg.cells_per_color
    ncell = cellcfg.ncell

    def one_pass(pot, table, states, gm, dpos_eff, pkey, draws=None):
        if draws is None:
            draws = pass_draws(pkey, ncolors, m, dpos_eff)
        shift, u, disp, ln_u = draws
        r = states.box.shape[0]
        posw = GH.wrap(gm.pos_ext[:, :gm.natoms], states.box)
        sorted_ids, start, count = cells_ops.bin_particles(
            posw, states.box, ncell, shift)
        colours = torch.arange(ncolors, device=table.device).expand(r, -1)
        pids, valid = CB.pick_movers(table, colours, count, start,
                                     sorted_ids, u)
        nbeta = -(1.0 / (kb * states.temp))[:, None]
        step = DD.compiled(colour_step) if states.box.is_cuda \
            else colour_step
        pos_ext, pe = gm.pos_ext, states.pe
        accs = []
        for c in range(ncolors):
            pos_ext, pe, acc = step(
                pot, pos_ext, gm.parent_ext, gm.slots_of, pids[:, c],
                valid[:, c], disp[:, c], ln_u[:, c], nbeta, pe)
            accs.append(acc)
        nap = states.nap + torch.stack(accs, 1).sum((1, 2),
                                                    dtype=torch.int32)
        ntp = states.ntp + valid.sum((1, 2), dtype=torch.int32)
        return (states.replace(pe=pe, nap=nap, ntp=ntp),
                gm.replace(pos_ext=pos_ext))

    return one_pass


def volume_trial(pot, p2e, states, gm, nbeta, v2u, ln_u):
    """One isotropic NPT volume trial of every replica from its draws
    (``moves.volume_draws``: 2u - 1 and ln u, (R,)) on the ghost-extended
    set, every extended position rescaled. Returns (states, gm, acc);
    the caller counts the trial."""
    n = gm.natoms
    vol = box_volume(states.box)
    dv = states.dvol * v2u
    vol_new = vol + dv
    ok = vol_new > 0.0
    ratio = vol_new / vol
    s = torch.where(ok, moves.cbrt(ratio), 1.0)
    gm_s = GH.scaled(gm, s)
    pe_new, vir_new = DD.total_energy_virial_dense(pot, gm_s)
    ln_acc = (nbeta * ((pe_new - states.pe) + states.press * p2e * dv)
              + n * torch.log(torch.where(ok, ratio, 1.0)))
    acc = ok & (ln_u < ln_acc)

    def pick(a, b):
        return torch.where(acc.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    gm = GH.GhostMap(**{f: pick(getattr(gm_s, f), getattr(gm, f))
                        for f in GH.FIELDS})
    states = states.replace(
        box=pick(states.box * s[:, None], states.box),
        pe=pick(pe_new, states.pe), virial=pick(vir_new, states.virial))
    return states, gm, acc


def make_dense_vol_fn(kb, p2e):
    """Build ``vol(pot, states, gm, key) -> (states, gm)``: one volume
    trial of every replica on its key (R, 2). The caller must first check
    coverage for the worst shrink (``needs_rebuild(..., shrink=)``)."""

    def volume_move(pot, states, gm, key):
        v2u, ln_u = moves.volume_draws(key)
        states, gm, acc = volume_trial(pot, p2e, states, gm,
                                       -(1.0 / (kb * states.temp)), v2u,
                                       ln_u)
        return states.replace(nav=states.nav + acc.to(torch.int32),
                              ntv=states.ntv + 1), gm

    return volume_move


def make_dense_sweep_fn(kb, p2e, cellcfg: cells_ops.CellConfig,
                        npasses: int = 1, nvol: int = 1):
    """Build ``sweep(pot, table, states, gm) -> (states, gm, diag)``, diag
    (R,) int32: the JAX package's legacy per-sweep composition, with no
    coverage check between passes (the pass keys a ``split`` of the
    sweep's pass key). Production runs go through ``make_dense_run_fn``,
    which owns the coverage discipline."""
    one_pass = make_dense_pass_fn(kb, cellcfg)
    volume_move = make_dense_vol_fn(kb, p2e)

    def sweep(pot, table, states, gm):
        key, kpass, kvol = jrandom.split(states.key, 3).unbind(-2)
        states = states.replace(key=key)
        margin = dense_dpos_margin(pot, cellcfg, states.box)
        room = torch.clamp(gm.shell - pot.rc, min=0.0)
        dpos_eff = torch.minimum(states.dpos, torch.minimum(
            0.5 * margin, CB.div(room, 2.0 * _SQ3)))
        diag = torch.where(margin <= 0.0, CB.DIAG_CB_INVALID,
                           0).to(torch.int32)
        for pk in jrandom.split(kpass, npasses).unbind(-2):
            states, gm = one_pass(pot, table, states, gm, dpos_eff, pk)
        for v in range(nvol):
            states, gm = volume_move(pot, states, gm,
                                     jrandom.fold_in(kvol, v))
        diag = diag | torch.where(gm.overflow, DIAG_GHOST_OVERFLOW,
                                  0).to(torch.int32)
        return states.replace(sweep=states.sweep + 1), gm, diag

    return sweep


def _any_stale(pot, pos_ext, ref_pos, shell, budget, shrink):
    """One 0-dim flag: ``needs_rebuild`` of any replica."""
    return torch.any(GH.stale(pos_ext, ref_pos, shell, pot.rc, budget,
                              shrink))


def make_dense_run_fn(kb, p2e, cellcfg: cells_ops.CellConfig, shell: float,
                      gcap: int, mod: int, nrecords: int, npasses: int = 1,
                      nvol: int = 1, targets=(0.5, 0.5, 0.5),
                      factor: float = 1.0625, write_traj: bool = False,
                      exchange: bool = False, npress: int = 0,
                      ntemp: int = 0, graphs: bool = True):
    """Build the dense ensemble run function (one process).

    Without exchange:
      ``run(states, gms, pot, table) ->
        (states, gms, recs, frames, diag, tried)``
    With exchange (parallel tempering: configurations stay put, slot
    identities move):
      ``run(states, gms, slot_of, xkey, pot, table, t_grid, p_grid) ->
        (states, gms, slot_of, recs, frames, slots_hist, xacc, diag,
         tried)``

    The JAX outputs in the JAX order, plus ``tried``, the attempted
    position and volume moves (0-dim int64). ``states`` carry per-replica
    keys; ``gms`` is their ghost map (``build_ensemble_ghosts``) with
    ``shell`` and capacity ``gcap``, rebuilt with them; ``table`` is
    ``cellcfg.active_table`` as an int64 tensor on the states' device,
    ``xkey`` a key (2,) there. At every record the positions are synced
    (wrapped) from the ghost map and pe and the virial are recomputed
    from it (drift-free records), then the step sizes adapt; with
    exchange an event follows, keyed ``fold_in(fold_in(xkey, e),
    sweep)``. recs fields are (nrecords, R) in replica order, frames
    (positions, boxes) taken after each block's adaptation, ``slots_hist``
    each replica's slot before the event, ``xacc`` (nrecords,) accepted
    swaps, ``diag`` 0-dim int32 bits. ``graphs`` replays the stages from
    CUDA graphs on the card; one run function serves one potential.
    """
    one_pass = make_dense_pass_fn(kb, cellcfg)
    ncolors, m = cellcfg.ncolors, cellcfg.cells_per_color
    stage = make_stage(graphs, COUNTS)


    def run_stages(pot, table, states, gm, diag, v2u, shift, u, fdisp,
                   ln_u, vln_u):
        """One sweep of the stages from its draws (``block_draws``, the
        sweep's slice): (states, gm, diag)."""
        n = states.pos.shape[1]

        def head(dpos, box, dvol, pos_ext, ref_pos, shell_, fdisp):
            margin_cb = dense_dpos_margin(pot, cellcfg, box)
            room = torch.clamp(shell_ - pot.rc, min=0.0)
            dpos_eff = torch.minimum(dpos, torch.minimum(
                0.5 * margin_cb, CB.div(room, 2.0 * _SQ3)))
            dpos_eff = torch.clamp(dpos_eff, min=0.0)
            budget = _SQ3 * dpos_eff
            bits = torch.where(torch.any(margin_cb <= 0.0),
                               CB.DIAG_CB_INVALID, 0).to(torch.int32)
            # the volume trials' worst isotropic shrink over every
            # replica (box and dvol stay put through the passes)
            vol = box_volume(box)
            shrink = torch.min(moves.cbrt(
                torch.maximum(vol - nvol * dvol, 0.01 * vol) / vol))
            return (budget, shrink, bits,
                    _any_stale(pot, pos_ext, ref_pos, shell_, budget, 1.0),
                    CB.scale_disp(fdisp, dpos_eff))

        def build(pos_ext, box):
            g = GH.build(GH.wrap(pos_ext[:, :n], box), box, shell, gcap)
            return tuple(getattr(g, f) for f in GH.FIELDS)

        def pass_(pos_ext, parent_ext, slots_of, ref_pos, shell_, box, temp,
                  pe, nap, ntp, budget, shrink, table, *draws):
            st = states.replace(box=box, temp=temp, pe=pe, nap=nap, ntp=ntp)
            g = gm.replace(pos_ext=pos_ext, parent_ext=parent_ext,
                           slots_of=slots_of, ref_pos=ref_pos)
            st, g = one_pass(pot, table, st, g, None, None, draws=draws)
            # the next pass's rebuild decision, and the volume trials'
            flags = torch.stack([
                _any_stale(pot, g.pos_ext, ref_pos, shell_, budget, 1.0),
                _any_stale(pot, g.pos_ext, ref_pos, shell_, 0.0, shrink)])
            return g.pos_ext, st.pe, st.nap, st.ntp, flags

        def tail(pos_ext, parent_ext, sign, slots_of, nghost, ref_pos,
                 ref_box, shell_, overflow, box, temp, press, pe, virial,
                 dvol, nav, ntv, sweep, v2u, vln_u):
            g = GH.GhostMap(pos_ext, parent_ext, sign, slots_of, nghost,
                            ref_pos, ref_box, shell_, overflow)
            st = states.replace(box=box, temp=temp, press=press, pe=pe,
                                virial=virial, dvol=dvol)
            nbeta = -(1.0 / (kb * temp))
            for v in range(nvol):
                st, g, acc = volume_trial(pot, p2e, st, g, nbeta, v2u[:, v],
                                          vln_u[:, v])
                nav = nav + acc.to(torch.int32)
                ntv = ntv + 1
            bits = torch.where(torch.any(overflow), DIAG_GHOST_OVERFLOW,
                               0).to(torch.int32)
            return (g.pos_ext, g.ref_pos, g.ref_box, g.shell, st.box, st.pe,
                    st.virial, nav, ntv, sweep + 1, bits)

        def rebuild_if(flag, gm):
            # a global decision, as the JAX engine's jnp.any(stale)
            COUNTS["syncs"] += 1
            if not bool(flag):
                return gm
            COUNTS["rebuilds"] += 1
            return GH.GhostMap(*stage("build", build,
                                      (gm.pos_ext, states.box)))

        budget, shrink, bits, flag, disp = stage(
            "head", head, (states.dpos, states.box, states.dvol, gm.pos_ext,
                           gm.ref_pos, gm.shell, fdisp), keep=(4, 5))
        draws = (shift, u, disp, ln_u)
        diag = diag | bits
        for p in range(npasses):
            gm = rebuild_if(flag, gm)
            pos_ext, pe, nap, ntp, flags = stage(
                "pass", pass_,
                (gm.pos_ext, gm.parent_ext, gm.slots_of, gm.ref_pos,
                 gm.shell, states.box, states.temp, states.pe, states.nap,
                 states.ntp, budget, shrink, table,
                 *(d[:, p].contiguous() for d in draws)),
                keep=(1, 2, 3, 4, 12))
            gm = gm.replace(pos_ext=pos_ext)
            states = states.replace(pe=pe, nap=nap, ntp=ntp)
            flag = flags[0]
            COUNTS["passes"] += 1
        if nvol:
            gm = rebuild_if(flags[1], gm)
        (pos_ext, ref_pos, ref_box, shell_, box, pe, vir, nav, ntv, sweep,
         bits) = stage("tail", tail,
                       (gm.pos_ext, gm.parent_ext, gm.sign, gm.slots_of,
                        gm.nghost, gm.ref_pos, gm.ref_box, gm.shell,
                        gm.overflow, states.box, states.temp, states.press,
                        states.pe, states.virial, states.dvol, states.nav,
                        states.ntv, states.sweep, v2u, vln_u),
                       keep=(1, 2, 3, 4, 8))
        gm = gm.replace(pos_ext=pos_ext, ref_pos=ref_pos, ref_box=ref_box,
                        shell=shell_)
        states = states.replace(box=box, pe=pe, virial=vir, nav=nav,
                                ntv=ntv, sweep=sweep)
        COUNTS["sweeps"] += 1
        return states, gm, diag | bits

    def block_core(pot, table, states, gm, diag, tried):
        for span in CB.draw_spans(mod, states.box.shape[0] * npasses
                                  * ncolors * m):
            key, *draws = stage(
                f"draws{span}", lambda k, span=span: block_draws(
                    k, span, npasses, nvol, ncolors, m), (states.key,))
            states = states.replace(key=key)
            for k in range(span):
                states, gm, diag = run_stages(
                    pot, table, states, gm, diag, *(d[:, k] for d in draws))
        # sync positions and drift-free energies at the record
        pe, vir = DD.total_energy_virial_dense(pot, gm)
        states = states.replace(pe=pe, virial=vir,
                                pos=GH.wrap(gm.pos_ext[:, :gm.natoms],
                                            states.box))
        rec = make_record(states, kb)
        tried = tried + states.ntp.sum() + states.ntv.sum()
        states = adapt_step_sizes(states, targets=targets, factor=factor)
        frame = (states.pos.clone(), states.box.clone()) if write_traj \
            else None
        return states, gm, diag, tried, rec, frame

    def start(states):
        dev = states.box.device
        return (torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))

    def finish(recs, frames):
        recs = stack_records(recs)
        if write_traj:
            frames = (torch.stack([f[0] for f in frames]),
                      torch.stack([f[1] for f in frames]))
        else:
            frames = None
        return recs, frames

    if not exchange:
        def run(states, gms, pot, table):
            diag, tried = start(states)
            recs, frames = [], []
            for _ in range(nrecords):
                states, gms, diag, tried, rec, frame = block_core(
                    pot, table, states, gms, diag, tried)
                recs.append(rec)
                frames.append(frame)
            recs, frames = finish(recs, frames)
            return states, gms, recs, frames, diag, tried

        return run

    if npress * ntemp <= 0:
        raise ValueError("the exchange runner needs the (P, T) grid shape")

    def run_x(states, gms, slot_of, xkey, pot, table, t_grid, p_grid):
        diag, tried = start(states)
        recs, frames, hist, xacc = [], [], [], []
        for event_idx in range(nrecords):
            states, gms, diag, tried, rec, frame = block_core(
                pot, table, states, gms, diag, tried)
            hist.append(slot_of)     # attribution BEFORE the exchange
            # the global sweep counter folded in: chained chunks and
            # restarts never replay an exchange-uniform sequence
            ekey = jrandom.fold_in(jrandom.fold_in(xkey, event_idx),
                                   states.sweep[0])
            states, slot_of, n_acc = tempering.exchange_event_keyed(
                states, slot_of, ekey, event_idx, npress, ntemp, t_grid,
                p_grid, kb, p2e)
            recs.append(rec)
            frames.append(frame)
            xacc.append(n_acc)
        recs, frames = finish(recs, frames)
        return (states, gms, slot_of, recs, frames, torch.stack(hist),
                torch.stack(xacc), diag, tried)

    return run_x


def build_ensemble_ghosts(states, shell: float, gcap: int) -> GH.GhostMap:
    """The ensemble's ghost map: ``ghosts.build`` of its positions."""
    return GH.build(states.pos, states.box, shell, gcap)
