"""Thermo records and the record-block driver (counterpart of
``neuralmelting_tpu.sampler.driver``).

``ThermoRecord`` / ``make_record`` serve an ensemble (fields (R,)) and one
serial chain (0-dim fields) alike. ``make_run_fn`` is the serial chain's
driver: record blocks of ``mod`` sweeps, a record, step-size adaptation
and a trajectory frame, as the JAX ``lax.scan`` over blocks, here a host
loop that reads nothing back from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from neuralmelting_tpu_torch.sampler.adapt import adapt_step_sizes
from neuralmelting_tpu_torch.sampler.state import box_volume


@dataclasses.dataclass
class ThermoRecord:
    """One thermo line per replica (reference .thrm row); a chunk's
    records stack these fields to (nrec, R)."""
    sweep: torch.Tensor
    temp: torch.Tensor
    press: torch.Tensor
    pe: torch.Tensor
    ke: torch.Tensor
    virial: torch.Tensor
    vol: torch.Tensor
    acc_pos: torch.Tensor
    acc_vol: torch.Tensor
    acc_hmc: torch.Tensor
    dpos: torch.Tensor
    dvol: torch.Tensor
    dt: torch.Tensor


def _ratio(nacc, ntry):
    return torch.where(ntry > 0,
                       nacc.to(torch.float32) / torch.clamp(ntry, min=1),
                       0.0)


def make_record(state, kb) -> ThermoRecord:
    n = state.pos.shape[-2]
    return ThermoRecord(
        sweep=state.sweep.clone(),
        temp=state.temp.clone(),
        press=state.press.clone(),
        pe=state.pe.clone(),
        ke=1.5 * n * kb * state.temp,
        virial=state.virial.clone(),
        vol=box_volume(state.box),
        acc_pos=_ratio(state.nap, state.ntp),
        acc_vol=_ratio(state.nav, state.ntv),
        acc_hmc=_ratio(state.nah, state.nth),
        dpos=state.dpos.clone(),
        dvol=state.dvol.clone(),
        dt=state.dt.clone(),
    )


def stack_records(recs) -> ThermoRecord:
    """A list of per-record ThermoRecords -> one with (nrec, R) fields."""
    return ThermoRecord(**{
        f.name: torch.stack([getattr(r, f.name) for r in recs])
        for f in dataclasses.fields(ThermoRecord)})


def make_run_fn(sweep_fn: Callable, kb: float, mod: int, nrecords: int,
                targets=(0.5, 0.5, 0.5), factor: float = 1.0625,
                write_traj: bool = True):
    """Build ``run(pot, state) -> (state, records, frames)``.

    ``sweep_fn(pot, state)`` is one sweep (``sampler.serial``). records:
    a ThermoRecord with leading axis nrecords; frames: (positions, boxes)
    with leading axis nrecords, taken after each block's adaptation, or
    None.
    """

    def run(pot, state):
        recs, pos, box = [], [], []
        for _ in range(nrecords):
            for _ in range(mod):
                state = sweep_fn(pot, state)
            recs.append(make_record(state, kb))
            state = adapt_step_sizes(state, targets=targets, factor=factor)
            if write_traj:
                pos.append(state.pos.clone())
                box.append(state.box.clone())
        frames = (torch.stack(pos), torch.stack(box)) if write_traj else None
        return state, stack_records(recs), frames

    return run
