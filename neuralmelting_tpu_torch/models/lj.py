"""Lennard-Jones 12-6 pair potential, truncated (unshifted) at rc.

Counterpart of ``neuralmelting_tpu.models.lj.LJCut``: LAMMPS
``pair_style lj/cut`` semantics, e(r) = 4 eps ((sigma/r)^12 - (sigma/r)^6)
for r < rc, else 0. Here it is a plain dataclass of Python floats; the
kernels receive it as the (4,) f32 tensor ``pot3`` = [eps, sigma, rc, 0].
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LJCut:
    eps: float = 1.0
    sigma: float = 1.0
    rc: float = 2.5

    @property
    def rc_host(self) -> float:
        """Host-side cutoff used for cell geometry (the JAX field name)."""
        return float(self.rc)

    @classmethod
    def create(cls, eps: float = 1.0, sigma: float = 1.0,
               rc: float = 2.5) -> "LJCut":
        return cls(float(eps), float(sigma), float(rc))

    def pot3(self, device) -> torch.Tensor:
        """[eps, sigma, rc, 0] as the kernels' (4,) f32 parameter tensor."""
        return torch.tensor([self.eps, self.sigma, self.rc, 0.0],
                            dtype=torch.float32, device=device)
