"""Uniform potential interface of the gather engine (counterpart of
``neuralmelting_tpu.ops.potential_ops``).

One sweep implementation serves pair potentials (LJ, ``ops/neighbors.py``)
and EAM (``ops/eam_energy.py``). ``aux`` is potential-specific cached
state threaded through the sampler: empty (R, 0) for pair potentials,
the per-atom density cache (R, N) for EAM.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from neuralmelting_tpu_torch.ops import eam_energy as EE
from neuralmelting_tpu_torch.ops import neighbors as NB


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


eam_ops = PotentialOps(
    kind="eam",
    range_factor=2.0,
    init_aux=EE.rho_sums,
    total=EE.total_energy_virial,
    delta=EE.delta_moves,
    apply_accept=EE.apply_accept,
    forces=EE.forces,
)


def ops_for_style(style: str) -> PotentialOps:
    return eam_ops if style == "eam" else pair_ops


def ops_for(pot) -> PotentialOps:
    return ops_for_style(getattr(pot, "kind", "pair"))
