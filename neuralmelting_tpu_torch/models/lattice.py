"""Crystal supercell builders (numpy).

A copy of ``neuralmelting_tpu.models.lattice``: that package's
``models/__init__.py`` imports its jax LJ module, so importing the
original would pull jax into the port.
"""

from __future__ import annotations

import numpy as np

# Fractional basis of each supported Bravais lattice within the cubic
# conventional cell.
_BASES = {
    "sc": np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array(
        [
            [0.0, 0.0, 0.0],
            [0.5, 0.5, 0.0],
            [0.5, 0.0, 0.5],
            [0.0, 0.5, 0.5],
        ]
    ),
}

ATOMS_PER_CELL = {k: len(v) for k, v in _BASES.items()}


def make_supercell(lattice: str, a: float, ncells, dtype=np.float32):
    """Build an ``(nx, ny, nz)`` supercell of conventional cubic cells.

    Args:
      lattice: one of ``sc``, ``bcc``, ``fcc``.
      a: conventional lattice constant (length units of the run).
      ncells: int (cubic) or 3-tuple of cells per axis.

    Returns:
      positions: (N, 3) array in [0, box) per axis.
      box: (3,) box edge lengths.
    """
    if lattice not in _BASES:
        raise ValueError(f"unknown lattice {lattice!r}; choose from {sorted(_BASES)}")
    if np.isscalar(ncells):
        ncells = (int(ncells),) * 3
    nx, ny, nz = (int(n) for n in ncells)
    basis = _BASES[lattice]

    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    corners = np.stack([ii, jj, kk], axis=-1).reshape(-1, 1, 3)  # (ncell, 1, 3)
    frac = corners + basis[None, :, :]  # (ncell, nbasis, 3)
    pos = (frac.reshape(-1, 3) * a).astype(dtype)
    box = (np.array([nx, ny, nz], dtype=np.float64) * a).astype(dtype)
    return pos, box


def natoms(lattice: str, ncells) -> int:
    if np.isscalar(ncells):
        ncells = (int(ncells),) * 3
    n = int(np.prod([int(c) for c in ncells]))
    return n * ATOMS_PER_CELL[lattice]
