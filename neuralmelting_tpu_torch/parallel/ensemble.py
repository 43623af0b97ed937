"""The gather engine: the (P, T) replica ensemble advanced by checkerboard
passes over neighbour lists (counterpart of
``neuralmelting_tpu.parallel.ensemble``).

The ensemble is one ``MCState`` with a leading replica axis, advanced in
record blocks of ``mod`` sweeps (sampler/checkerboard.py), with
drift-free record energetics, step-size adaptation and, with exchange,
keyed parallel-tempering events between record blocks
(``tempering.exchange_event_keyed``: the event's key folds in the event
index and the sweep counter, as in the JAX package).

Neighbour lists are rebuilt globally: before every pass, and before the
tail, any replica whose skin invariant would not survive the coming
stage (its displacement budget: sqrt(3) dpos_eff a pass; the tail's
worst volume shrink and a 4-sigma bound on HMC drift) rebuilds all
replicas. Where the JAX engine decides that in a ``lax.cond`` on the
device, here the host reads the decision: one sync before every pass
and before the tail (``COUNTS``). After an HMC tail the list is checked
again, and a violation sets ``DIAG_NL_STALE``.

Under more than one process (parallel/mesh.py) each rank runs this on
its shard of the replicas, each replica with its global key, and the
decisions stay global, as the JAX program's are under GSPMD: every
rebuild decision is ORed over the ranks (``mesh.any_ranks``; ``COUNTS``
also counts the rebuilds a rank made for another's replicas), the
tail's worst shrink is a min over them, and the exchange runs on
gathered values (``tempering.exchange_gathered``), which also OR the
diag bits. The collectives sit between the stages, never inside a
captured graph. The ranks so make the decisions of one process.

The draws that do not depend on the state (the replica keys' chain,
every pass's draws, the volume trials') are made for a span of sweeps
at once (``CB.draw_spans``), in one stage, as the sweeps would make them
one by one. A sweep is four kinds of stage, each a function of tensors
only: the head (dpos_eff, the passes' displacements scaled by it, the
first rebuild decision), the list build, a pass (which ends with the
next two rebuild decisions) and the tail (volume trials, HMC, the diag
bits). On
the card each stage is replayed from a CUDA graph captured from the same
function at its first call (one graph per stage and input shape): the
same kernels in the same order, so the same bits as eager execution
(chip_smoke holds them to it), without a host launch for each of a
pass's small operations (its colour substeps are compiled:
``checkerboard.compiled_colour_step``). The graphs live as long as the
run function. On the CPU the stages run eagerly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.ops import neighbors as NB
from neuralmelting_tpu_torch.ops import potential_ops as PO
from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler import tempering
from neuralmelting_tpu_torch.sampler.adapt import adapt_step_sizes
from neuralmelting_tpu_torch.sampler.driver import make_record, stack_records
from neuralmelting_tpu_torch.sampler.moves import cbrt, volume_draws
from neuralmelting_tpu_torch.sampler.state import box_volume

# host-side counts since the last reset_counts(): sweeps, passes, host
# syncs (rebuild decisions; each one a collective under more than one
# process), global rebuilds, CUDA graph replays, and the rebuilds this
# rank made only because another rank's replicas raised the flag
COUNTS = {"sweeps": 0, "passes": 0, "syncs": 0, "rebuilds": 0,
          "replays": 0, "remote_rebuilds": 0}

_SQ3 = 3.0 ** 0.5


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def or_reduce(d):
    """Bitwise-OR a (R,) int32 flag array into a 0-dim int32."""
    out = torch.zeros((), dtype=torch.int32, device=d.device)
    for b in range(8):
        out = out | torch.where(torch.any(((d >> b) & 1) == 1), 1 << b,
                                0).to(torch.int32)
    return out


class _Graphed:
    """``fn(*tensors) -> tuple of tensors`` replayed from a CUDA graph.

    The first call with a new input signature warms ``fn`` up on a side
    stream and captures it against static copies of its inputs; every
    call copies its inputs into them (inputs at the positions ``keep``
    only when the caller passes another tensor than last time: they are
    never changed in place), replays, counts the replay in ``counts``
    (default ``COUNTS``) and returns clones of the outputs. ``fn`` must
    not read back from the device or copy host data to it.
    """

    def __init__(self, fn, keep=(), counts=None):
        self.fn, self.keep, self.cache = fn, frozenset(keep), {}
        self.counts = COUNTS if counts is None else counts

    def __call__(self, *args):
        sig = tuple((tuple(a.shape), a.dtype) for a in args)
        if sig not in self.cache:
            self.cache[sig] = self._capture(args)
        graph, static, out, last = self.cache[sig]
        for i, (s, a) in enumerate(zip(static, args)):
            if i in self.keep and last[i] is a:
                continue
            s.copy_(a)
            last[i] = a
        graph.replay()
        self.counts["replays"] += 1
        return tuple(o.clone() for o in out)

    def _capture(self, args):
        static = [a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*[a.clone() for a in args])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*static)
        return graph, static, out, [None] * len(args)


def make_stage(graphs: bool, counts=None):
    """``stage(name, fn, args, keep=())``: ``fn(*args)``, replayed from the
    CUDA graph kept under ``name`` (``_Graphed``, its replays counted in
    ``counts``) when ``graphs`` is set and ``args[0]`` lies on the card,
    else run eagerly."""
    graphed = {}

    def stage(name, fn, args, keep=()):
        if not (graphs and args[0].is_cuda):
            return fn(*args)
        if name not in graphed:
            graphed[name] = _Graphed(fn, keep, counts)
        return graphed[name](*args)

    return stage


def _lists(idx, count, ref_pos, ref_box, rlist, overflow=None):
    return NB.NeighborList(idx=idx, count=count, ref_pos=ref_pos,
                           ref_box=ref_box, rlist=rlist, overflow=overflow)


def make_ensemble_run_fn(kb, p2e, cellcfg, skin: float, capacity: int,
                         mod: int, nrecords: int, npasses: int = 0,
                         nvol: int = 1,
                         nhmc: int = 0, nstps: int = 16, mass: float = 1.0,
                         targets=(0.5, 0.5, 0.5), factor: float = 1.0625,
                         natoms: int = 0,
                         exchange: bool = False, npress: int = 0,
                         ntemp: int = 0, style: str = "pair",
                         write_traj: bool = True, graphs: bool = True):
    """Build the ensemble run function.

    Without exchange:
      ``run(states, nls, aux, pot, table) ->
        (states, nls, aux, recs, frames, diag, tried)``
    With exchange:
      ``run(states, nls, aux, slot_of, xkey, pot, table, t_grid, p_grid) ->
        (states, nls, aux, slot_of, recs, frames, slots_hist, xacc, diag,
         tried)``

    The JAX outputs in the JAX order, plus ``tried``, the attempted
    position and volume moves of the run (0-dim int64). ``states`` carry
    per-replica keys (``ensemble_init(..., seed=)``); ``table`` is
    ``cellcfg.active_table`` as an int64 tensor on their device, ``xkey``
    a key (2,) there. recs fields are (nrecords, R) in replica order,
    frames (positions, boxes) taken after each block's adaptation,
    ``slots_hist`` (nrecords, R) each replica's slot at record time,
    ``xacc`` (nrecords,) accepted swaps, ``diag`` 0-dim int32 bits.
    ``npasses=0`` picks ~N attempts a sweep (needs ``natoms``).
    ``graphs`` replays the stages from CUDA graphs on the card. One run
    function serves one potential object: the graphs hold its constants
    (LJ) or its device tables (EAM, ``models.eam.EAMTables``). ``aux`` is
    the potential's cache (``build_ensemble_aux``); for EAM it is rebuilt
    from scratch after every tail and at every record.
    """
    if npasses <= 0:
        if natoms <= 0:
            raise ValueError("pass npasses or natoms")
        npasses = CB.default_npasses(natoms, cellcfg)
    pops = PO.ops_for_style(style)
    one_pass = CB.make_cb_pass_fn(kb, cellcfg, style)
    tail = CB.make_cb_tail_fn(kb, p2e, nvol, nhmc, nstps, mass, style)
    stage = make_stage(graphs)
    multi = mesh.process_count() > 1

    def draws_(key, span):
        """``span`` sweeps' state-free draws from the replicas' keys (R,
        2): (the key after them, each sweep's HMC key (R, span, 2), its
        volume trials' 2u - 1 and ln u (R, span, nvol), then every pass's
        ``CB.pass_floats`` (R, span, npasses, ...))."""
        kpass, kvol, khmc = [], [], []
        for _ in range(span):
            key, kp, kv, kh = jrandom.split(key, 4).unbind(-2)
            kpass.append(kp)
            kvol.append(kv)
            khmc.append(kh)
        dev = key.device
        pkeys = jrandom.fold_in(torch.stack(kpass, 1)[:, :, None, :],
                                torch.arange(npasses, device=dev))
        v2u, vln_u = volume_draws(jrandom.fold_in(
            torch.stack(kvol, 1)[:, :, None, :],
            torch.arange(nvol, device=dev)))
        return (key, torch.stack(khmc, 1), v2u, vln_u,
                *CB.pass_floats(pkeys, cellcfg.ncolors,
                                cellcfg.cells_per_color))

    def run_stages(pot, table, states, nls, aux, diag, khmc, v2u, vln_u,
                   *floats):
        """One sweep of the stages from its draws (``draws_``, the sweep's
        slice): (states, nls, aux, diag)."""
        rc = pot.rc

        def stale(ref_pos, ref_box, rlist, pos, box, budget, shrink):
            return torch.any(NB.needs_rebuild(
                _lists(None, None, ref_pos, ref_box, rlist), pos, box, rc,
                budget=budget, shrink=shrink))

        def head(dpos, pos, box, dvol, ref_pos, ref_box, rlist, fdisp):
            # per-replica dpos clamp: checkerboard independence AND enough
            # skin headroom that one pass per fresh rebuild is always legal
            margin_cb = CB.cb_dpos_margin(pops, pot, cellcfg, box)
            s_min = torch.min(box / ref_box, dim=-1).values
            room = torch.clamp(rlist * s_min - rc, min=0.0)
            dpos_eff = torch.minimum(dpos, torch.minimum(
                0.5 * margin_cb, CB.div(room, 2.0 * _SQ3)))
            dpos_eff = torch.clamp(dpos_eff, min=0.0)
            budget = _SQ3 * dpos_eff        # one move per particle per pass
            bits = torch.where(torch.any(margin_cb <= 0.0),
                               CB.DIAG_CB_INVALID, 0).to(torch.int32)
            # the tail's worst isotropic shrink over nvol volume trials
            # (box and dvol stay put through the passes)
            vol = box_volume(box)
            shrink = torch.min(cbrt(
                torch.maximum(vol - nvol * dvol, 0.01 * vol) / vol))
            return (dpos_eff, budget, shrink, bits,
                    stale(ref_pos, ref_box, rlist, pos, box, budget, 1.0),
                    CB.scale_disp(fdisp, dpos_eff))

        def build(pos, box):
            nl = NB.build(pos, box, NB.f32_rlist(pot.rc_host, skin),
                          capacity)
            return nl.idx, nl.count, nl.ref_pos, nl.ref_box, nl.rlist, \
                nl.overflow

        def pass_(pos, box, temp, pe, virial, nap, ntp, dt, idx, count,
                  ref_pos, ref_box, rlist, dpos_eff, budget, shrink, table,
                  aux, *draws):
            st = states.replace(pos=pos, box=box, temp=temp, pe=pe,
                                virial=virial, nap=nap, ntp=ntp)
            st, aux = one_pass(pot, table, st,
                               _lists(idx, count, ref_pos, ref_box, rlist),
                               aux, dpos_eff, None, draws=draws)
            # the next pass's rebuild decision, and the tail's: the head's
            # worst shrink + a 4-sigma bound on HMC leapfrog drift
            b_hmc = 0.0
            if nhmc:
                b_hmc = nstps * dt * 4.0 * torch.sqrt(kb * temp / mass)
            flags = torch.stack([
                stale(ref_pos, ref_box, rlist, st.pos, box, budget, 1.0),
                stale(ref_pos, ref_box, rlist, st.pos, box, b_hmc, shrink)])
            return st.pos, st.pe, st.virial, st.nap, st.ntp, aux, flags

        def tail_(pos, box, temp, press, pe, virial, dvol, dt, nav, ntv, nah,
                  nth, sweep, idx, count, ref_pos, ref_box, rlist, overflow,
                  khmc, v2u, vln_u, aux):
            st = states.replace(pos=pos, box=box, temp=temp, press=press,
                                pe=pe, virial=virial, dvol=dvol, dt=dt,
                                nav=nav, ntv=ntv, nah=nah, nth=nth)
            bits = torch.where(torch.any(overflow), CB.DIAG_NL_OVERFLOW,
                               0).to(torch.int32)
            if nvol or nhmc:
                nl = _lists(idx, count, ref_pos, ref_box, rlist)
                st, aux = tail(pot, st, nl, aux, None, khmc,
                               vdraws=(v2u, vln_u))
                if nhmc:
                    # retroactive exactness check: flag if the trajectory
                    # drifted past the budget (its last energies may be
                    # stale)
                    bits = bits | torch.where(
                        stale(ref_pos, ref_box, rlist, st.pos, st.box, 0.0,
                              1.0), CB.DIAG_NL_STALE, 0).to(torch.int32)
            return (st.pos, st.box, st.pe, st.virial, st.nav, st.ntv, st.nah,
                    st.nth, sweep + 1, aux, bits)

        def rebuild_if(flag, nls):
            # a global decision, as the JAX engine's jnp.any(stale) over
            # the whole ensemble: ORed over the ranks between stages
            COUNTS["syncs"] += 1
            mine = bool(flag)
            if multi:
                if not bool(mesh.any_ranks(flag)):
                    return nls
                COUNTS["remote_rebuilds"] += int(not mine)
            elif not mine:
                return nls
            COUNTS["rebuilds"] += 1
            return _lists(*stage("build", build, (states.pos, states.box)))

        shift, order, u, fdisp, ln_u = floats
        dpos_eff, budget, shrink, bits, flag, disp = stage(
            "head", head, (states.dpos, states.pos, states.box, states.dvol,
                           nls.ref_pos, nls.ref_box, nls.rlist, fdisp),
            keep=(4, 5, 6))
        draws = (shift, order, u, disp, ln_u)
        diag = diag | bits
        if multi and (nvol or nhmc):
            # the worst shrink over the whole ensemble, as jnp.min is
            mesh.all_reduce_(shrink, dist.ReduceOp.MIN)
        for p in range(npasses):
            nls = rebuild_if(flag, nls)
            pos, pe, vir, nap, ntp, aux, flags = stage(
                "pass", pass_,
                (states.pos, states.box, states.temp, states.pe,
                 states.virial, states.nap, states.ntp, states.dt,
                 nls.idx, nls.count, nls.ref_pos, nls.ref_box, nls.rlist,
                 dpos_eff, budget, shrink, table, aux,
                 *(d[:, p].contiguous() for d in draws)),
                keep=(8, 9, 10, 11, 12, 16))
            states = states.replace(pos=pos, pe=pe, virial=vir, nap=nap,
                                    ntp=ntp)
            flag = flags[0]
            COUNTS["passes"] += 1
        if nvol or nhmc:
            nls = rebuild_if(flags[1], nls)
        (pos, box, pe, vir, nav, ntv, nah, nth, sweep, aux,
         bits) = stage("tail", tail_,
                       (states.pos, states.box, states.temp, states.press,
                        states.pe, states.virial, states.dvol, states.dt,
                        states.nav, states.ntv, states.nah, states.nth,
                        states.sweep, nls.idx, nls.count, nls.ref_pos,
                        nls.ref_box, nls.rlist, nls.overflow, khmc, v2u,
                        vln_u, aux), keep=tuple(range(13, 19)))
        states = states.replace(pos=pos, box=box, pe=pe, virial=vir, nav=nav,
                                ntv=ntv, nah=nah, nth=nth, sweep=sweep)
        COUNTS["sweeps"] += 1
        return states, nls, aux, diag | bits

    def block_core(pot, table, states, nls, aux, diag, tried):
        r = states.pos.shape[0]
        for span in CB.draw_spans(mod, r * npasses * cellcfg.ncolors
                                  * cellcfg.cells_per_color):
            key, *draws = stage(f"draws{span}",
                                lambda k, span=span: draws_(k, span),
                                (states.key,))
            states = states.replace(key=key)
            for k in range(span):
                states, nls, aux, diag = run_stages(
                    pot, table, states, nls, aux, diag,
                    *(d[:, k] for d in draws))
        # kill f32 drift of the incremental accumulators at every record;
        # also rebuild the potential cache (EAM rho) from scratch
        pe, vir = pops.total(pot, states.pos, states.box, nls)
        states = states.replace(pe=pe, virial=vir)
        if pops.kind != "pair":
            aux = pops.init_aux(pot, states.pos, states.box, nls)
        rec = make_record(states, kb)
        tried = tried + states.ntp.sum() + states.ntv.sum()
        states = adapt_step_sizes(states, targets=targets, factor=factor)
        frame = (states.pos.clone(), states.box.clone()) if write_traj \
            else None
        return states, nls, aux, diag, tried, rec, frame

    def start(states):
        dev = states.pos.device
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
        def run(states, nls, aux, pot, table):
            diag, tried = start(states)
            recs, frames = [], []
            for _ in range(nrecords):
                states, nls, aux, diag, tried, rec, frame = block_core(
                    pot, table, states, nls, aux, diag, tried)
                recs.append(rec)
                frames.append(frame)
            recs, frames = finish(recs, frames)
            return states, nls, aux, recs, frames, diag, tried

        return run

    if npress * ntemp <= 0:
        raise ValueError("the exchange runner needs the (P, T) grid shape")

    def run_x(states, nls, aux, slot_of, xkey, pot, table, t_grid, p_grid):
        diag, tried = start(states)
        recs, frames, hist, xacc = [], [], [], []
        for event_idx in range(nrecords):
            states, nls, aux, diag, tried, rec, frame = block_core(
                pot, table, states, nls, aux, diag, tried)
            hist.append(slot_of)     # attribution BEFORE the exchange
            # the global sweep counter folded in: chained chunks and
            # restarts never replay an exchange-uniform sequence
            ekey = jrandom.fold_in(jrandom.fold_in(xkey, event_idx),
                                   states.sweep[0])
            if multi:
                # every rank draws the whole event's uniforms and swaps
                # on gathered values; diag rides along, ORed over ranks
                states, slot_of, n_acc, rows = tempering.exchange_gathered(
                    states, slot_of, tempering.exchange_uniforms(
                        ekey, event_idx, npress, ntemp), event_idx, npress,
                    ntemp, t_grid, p_grid, kb, p2e, row=diag.reshape(1))
                diag = or_reduce(rows[:, 0].to(torch.int32))
            else:
                states, slot_of, n_acc = tempering.exchange_event_keyed(
                    states, slot_of, ekey, event_idx, npress, ntemp,
                    t_grid, p_grid, kb, p2e)
            recs.append(rec)
            frames.append(frame)
            xacc.append(n_acc)
        recs, frames = finish(recs, frames)
        return (states, nls, aux, slot_of, recs, frames, torch.stack(hist),
                torch.stack(xacc), diag, tried)

    return run_x


def build_ensemble_nl(pot, states, skin: float,
                      capacity: Optional[int] = None, box_host=None):
    """Per-replica neighbour lists for an ensemble: (lists, capacity).

    A run function is built for one capacity: when rebuilding lists for
    it, pass that capacity. Without one it is suggested from the density
    of ``box_host`` (a host numpy box; default: replica 0's box)."""
    if capacity is None:
        if box_host is None:
            box_host = states.box[0].cpu().numpy()
        capacity = NB.suggest_capacity(states.pos.shape[-2], box_host,
                                       pot.rc_host + skin)
    return NB.build(states.pos, states.box, NB.f32_rlist(pot.rc_host, skin),
                    capacity), capacity


def build_ensemble_aux(pot, states, nls):
    """Per-replica potential cache: the EAM density (R, N); empty (R, 0)
    for pair potentials."""
    return PO.ops_for(pot).init_aux(pot, states.pos, states.box, nls)


def table_tensor(cellcfg, device) -> torch.Tensor:
    """The colour table (ncolors, M) as the run functions take it."""
    return torch.as_tensor(np.asarray(cellcfg.active_table),
                           dtype=torch.int64, device=device)
