"""Multi-process cellmc: the kernel engines per replica shard (counterpart
of ``neuralmelting_tpu.parallel.cellmc_sharded``), LJ and EAM.

Each process runs the single-device chunk runner on its shard of the
replicas (parallel/mesh.py: shard index = rank), so kernels B1/B2 (LJ)
or B3/B4 (EAM) run on its own slabs with no traffic during a record
block. As in the JAX package's ``shard_map`` wrapper:

  * a record block is one call of the runner built with
    ``exchange=False, nrecords=1``, so the shard's volume and rebin key
    chain restarts at every block from ``fold_in(fold_in(key(0 or 2),
    seed0[0]), sweep)``;
  * the shard index is added to the kernel seed word and folded into the
    volume key; the rebin key stays shared, so the (3,) ``shift`` stays
    the same on every rank. After each block the ranks compare it (max
    and min across ranks): where they differ diag gets
    ``DIAG_SHIFT_DESYNC`` and the max is kept;
  * ``diag`` is reduced across ranks by bitwise OR (the JAX package's
    ``pmax`` keeps only the largest flag when two shards raise different
    bits: ROADMAP C13);
  * the exchange runs outside the shard: every rank gathers each
    replica's (pe, volume), its slot and its slot-attached fields, draws
    the same uniforms from ``fold_in(fold_in(xkey, event), sweep)``,
    computes the same swaps and applies them to its own replicas
    (``tempering.exchange_gathered``, which the gather engine shares).

One ``all_gather`` a record block carries all of it: R rows of 12 f64
(f32 and int32 values, exact) and one row a rank of (diag, shift).
Adaptation and records stay per shard.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.sampler import cellmc as SC
from neuralmelting_tpu_torch.sampler import tempering
from neuralmelting_tpu_torch.sampler.driver import stack_records


def _squeeze(rec):
    """A one-record ThermoRecord (1, R) -> (R,) fields."""
    return type(rec)(**{k: v[0] for k, v in vars(rec).items()})


def _block_flags(rows):
    """The ranks' (diag, shift) rows of ``tempering.exchange_gathered``:
    (diag OR'd over the ranks, shift max over the ranks, whether the
    shifts differed)."""
    d = rows[:, 0].to(torch.int32)
    dor = d[0]
    for k in range(1, d.shape[0]):
        dor = dor | d[k]
    sh = rows[:, 1:4].to(torch.float32)
    smax = torch.max(sh, dim=0).values
    desync = torch.any(smax != torch.min(sh, dim=0).values)
    return dor, smax, desync


def make_sharded_cellmc_run_fn(kb, p2e, geom, mod: int, nrecords: int,
                               npress: int, ntemp: int, ncyc: int = 4,
                               nvol: int = 1, vol_every: int = 1,
                               rebin_every: int = 1,
                               targets=(0.5, 0.5, 0.5),
                               factor: float = 1.0625, adapt: bool = True,
                               style: str = "pair",
                               write_traj: bool = False):
    """Build this rank's chunk runner, with the exchange runners'
    signature and returns (sampler/cellmc.py):

      ``run(states, slabs, count, shift, slot_of, xkey, pot, cell_tabs,
        t_grid, p_grid, seed0) -> (states, slabs, count, shift, slot_of,
        recs, frames, hist, xacc, diag, tried)``

    ``states``, ``slabs``, ``count``, ``slot_of`` are this rank's shard
    (mesh.to_global), ``t_grid`` / ``p_grid`` whole; the returned recs,
    frames and hist are the shard's (mesh.host_fetch gathers them), xacc,
    diag and shift the same on every rank, ``tried`` this rank's.
    ``style`` "pair" (B1/B2, ``pot`` an LJCut) or "eam" (B3/B4, ``pot``
    the EAMCheb, slabs with the density slab)."""
    if npress * ntemp <= 0:
        raise ValueError("the sharded runner needs the (P, T) grid shape")
    make = SC.make_eam_run_fn if style == "eam" else SC.make_cellmc_run_fn
    inner = make(kb, p2e, geom, mod=mod, nrecords=1, ncyc=ncyc, nvol=nvol,
                 targets=targets, factor=factor, write_traj=write_traj,
                 exchange=False, vol_every=vol_every,
                 rebin_every=rebin_every, adapt=adapt,
                 shard=mesh.process_index())

    def run(states, slabs, count, shift, slot_of, xkey, pot, cell_tabs,
            t_grid, p_grid, seed0):
        dev = states.box.device
        r = t_grid.shape[0]
        sweep0 = int(states.sweep[0])
        xu = SC.exchange_draws(xkey, sweep0, mod, nrecords, r, dev)
        diag = torch.zeros((), dtype=torch.int32, device=dev)
        tried = torch.zeros((), dtype=torch.int64, device=dev)
        recs, frames, hist, xacc = [], [], [], []
        for event_idx in range(nrecords):
            (states, slabs, count, shift, rec, frame, d,
             t) = inner(states, slabs, count, shift, pot, cell_tabs, seed0)
            tried = tried + t
            hist.append(slot_of)
            states, slot_of, n_acc, rows = tempering.exchange_gathered(
                states, slot_of, xu[event_idx], event_idx, npress, ntemp,
                t_grid, p_grid, kb, p2e,
                row=torch.cat([d.reshape(1).to(torch.float64),
                               shift.to(torch.float64)]))
            d, shift, desync = _block_flags(rows)
            diag = diag | d | torch.where(desync, SC.DIAG_SHIFT_DESYNC, 0)
            recs.append(_squeeze(rec))
            if write_traj:
                frames.append((frame[0][0], frame[1][0]))
            xacc.append(n_acc)
        recs = stack_records(recs)
        frames = ((torch.stack([f[0] for f in frames]),
                   torch.stack([f[1] for f in frames]))
                  if write_traj else None)
        return (states, slabs, count, shift, slot_of, recs, frames,
                torch.stack(hist), torch.stack(xacc), diag.to(torch.int32),
                tried)

    return run
