"""Thermo records (counterpart of ``ThermoRecord`` / ``make_record`` in
``neuralmelting_tpu.sampler.driver``), batched over replicas."""

from __future__ import annotations

import dataclasses

import torch

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
