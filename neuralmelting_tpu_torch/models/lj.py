"""Lennard-Jones 12-6 pair potential, truncated (unshifted) at rc.

Counterpart of ``neuralmelting_tpu.models.lj.LJCut``: LAMMPS
``pair_style lj/cut`` semantics, e(r) = 4 eps ((sigma/r)^12 - (sigma/r)^6)
for r < rc, else 0. Here it is a plain dataclass of Python floats; the
cell-MC kernels receive it as the (4,) f32 tensor ``pot3`` = [eps, sigma,
rc, 0], the brute-force ones as the f32 constants of ``f32_consts``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
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

    def f32_consts(self):
        """(sigma^2, rc^2, 4 eps, 24 eps), each computed in f32 from the f32
        parameters as the JAX package's f32 pytree computes them, returned
        as Python floats (exact f32 values: a scalar operand of an f32
        tensor op then carries the JAX bits without a device copy)."""
        return _f32_consts(self.eps, self.sigma, self.rc)

    def pair_e_w(self, r2):
        """Pair energy and virial w = r f = 24 eps (2 sr12 - sr6), in the
        JAX operation order (sr2 = sigma^2 / r2, sr6 = sr2 sr2 sr2, sr12 =
        sr6 sr6). The caller masks r2 >= rc^2; inputs must be > 0."""
        sig2, _, e4, w24 = self.f32_consts()
        # a tensor numerator: float / tensor would be reciprocal * float
        sr2 = r2.new_full((), sig2) / r2
        sr6 = sr2 * sr2 * sr2
        sr12 = sr6 * sr6
        return e4 * (sr12 - sr6), w24 * (2.0 * sr12 - sr6)


@functools.lru_cache(maxsize=None)
def _f32_consts(eps, sigma, rc):
    f = np.float32
    sig, rc, eps = f(sigma), f(rc), f(eps)
    return (float(sig * sig), float(rc * rc), float(f(4.0) * eps),
            float(f(24.0) * eps))
