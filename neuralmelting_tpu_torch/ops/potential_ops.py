"""Uniform potential interface of the gather engine (counterpart of
``neuralmelting_tpu.ops.potential_ops``).

``aux`` is potential-specific cached state threaded through the sampler:
empty for pair potentials, the per-atom density cache for EAM. Pair
potentials (LJ) are ported; EAM over neighbour lists
(``ops/eam_energy.py``) is ROADMAP A13 item 3, so ``eam_ops`` and every
lookup that selects it raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from neuralmelting_tpu_torch.ops import neighbors as NB

EAM_LATER = ("EAM over neighbour lists (the gather engine's ops/eam_energy.py)"
             " is not ported yet: ROADMAP A13 item 3; EAM runs on the cellmc "
             "engine (engine=\"cellmc\")")


@dataclasses.dataclass(frozen=True)
class PotentialOps:
    kind: str
    range_factor: float                 # cell sizing: rc * range_factor
    init_aux: Callable                  # (pot, pos, box, nl) -> aux
    total: Callable                     # (pot, pos, box, nl) -> (pe, vir)
    delta: Callable                     # (pot,pos,box,nl,aux,ids,new_r)
                                        #   -> (de, dw, payload)
    apply_accept: Callable              # (aux, ids, acc, payload) -> aux
    forces: Callable                    # (pot, pos, box, nl) -> (R,N,3)


def _pair_delta(pot, pos, box, nl, aux, ids, new_r):
    de, dw = NB.delta_moves(pot, pos, box, nl, ids, new_r)
    return de, dw, ()


pair_ops = PotentialOps(
    kind="pair",
    range_factor=1.0,
    init_aux=lambda pot, pos, box, nl: torch.zeros(
        (pos.shape[0], 0), dtype=torch.float32, device=pos.device),
    total=NB.pair_energy_virial,
    delta=_pair_delta,
    apply_accept=lambda aux, ids, acc, payload: aux,
    forces=NB.forces,
)


def _eam_later(*_args, **_kw):
    raise NotImplementedError(EAM_LATER)


eam_ops = PotentialOps(kind="eam", range_factor=2.0, init_aux=_eam_later,
                       total=_eam_later, delta=_eam_later,
                       apply_accept=_eam_later, forces=_eam_later)


def ops_for_style(style: str) -> PotentialOps:
    if style == "eam":
        raise NotImplementedError(EAM_LATER)
    return pair_ops


def ops_for(pot) -> PotentialOps:
    return ops_for_style(getattr(pot, "kind", "pair"))
