"""Checkerboard cell decomposition for batched Metropolis moves
(counterpart of ``neuralmelting_tpu.ops.cells``).

The box is cut into an (nx, ny, nz) grid with each axis count divisible
by ``stride``; cells whose coordinates are congruent mod ``stride`` share
a colour. Two distinct same-colour cells are separated by at least
(stride - 1) * cell_width, so with

    (stride - 1) * min(cell_width) >= rc + 2 * dpos

one particle per active-colour cell can be trialled and accepted in
parallel with exact Metropolis acceptance (Anderson et al.,
arXiv:1509.04692). A random fractional grid shift per pass restores
ergodicity across cell boundaries; a random colour order removes
directional bias.

Cell membership comes from a stable sort of the particles' cell ids, as
``jnp.argsort`` (stable) gives it, so the order, starts and counts equal
the JAX package's bit for bit. ``bin_particles`` works on a leading
replica axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CellConfig:
    ncell: tuple            # (nx, ny, nz), each divisible by stride
    stride: int
    active_table: np.ndarray  # (ncolors, M) int32 cell ids per colour

    @property
    def ncells_total(self) -> int:
        return int(np.prod(self.ncell))

    @property
    def ncolors(self) -> int:
        return self.stride ** 3

    @property
    def cells_per_color(self) -> int:
        return self.ncells_total // self.ncolors


def make_cell_config(box0, rc, stride=4, dpos_cap=0.25) -> CellConfig:
    """Choose the cell grid for the initial box ``box0`` (host numpy).

    Guarantees (stride-1)*w >= rc + 2*dpos_cap at the initial box; the
    sampler re-validates per sweep as the box fluctuates and clamps dpos.
    """
    box0 = np.asarray(box0, np.float64)
    w_min = (float(rc) + 2.0 * dpos_cap) / (stride - 1)
    ncell = []
    for b in box0:
        n = int(np.floor(b / w_min))
        n = (n // stride) * stride
        ncell.append(max(stride, n))
    ncell = tuple(ncell)
    if min(np.asarray(box0) / np.asarray(ncell)) * (stride - 1) < rc:
        raise ValueError(
            f"box {box0} too small for stride {stride} checkerboard at rc={rc}")

    nx, ny, nz = ncell
    cid = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    table = []
    for ax in range(stride):
        for ay in range(stride):
            for az in range(stride):
                table.append(cid[ax::stride, ay::stride, az::stride].ravel())
    return CellConfig(ncell=ncell, stride=stride,
                      active_table=np.asarray(table, np.int32))


def bin_particles(pos, box, ncell, shift_frac):
    """Sort the particles of each replica into cells of the shifted grid.

    pos (R, N, 3), box (R, 3), shift_frac (R, 3). Returns
      sorted_ids: (R, N) int64 particle indices ordered by cell id;
      start:      (R, C) int32 first slot in sorted_ids of each cell;
      count:      (R, C) int32 particles per cell.
    """
    n0, n1, n2 = (int(c) for c in ncell)
    frac = pos / box[:, None, :] + shift_frac[:, None, :]
    frac = frac - torch.floor(frac)
    c0 = torch.clamp((frac[..., 0] * n0).to(torch.int32), max=n0 - 1)
    c1 = torch.clamp((frac[..., 1] * n1).to(torch.int32), max=n1 - 1)
    c2 = torch.clamp((frac[..., 2] * n2).to(torch.int32), max=n2 - 1)
    cid = ((c0 * n1 + c1) * n2 + c2).long()
    order = torch.argsort(cid, dim=-1, stable=True)
    count = torch.zeros((pos.shape[0], n0 * n1 * n2), dtype=torch.int32,
                        device=pos.device)
    count.scatter_add_(1, cid, torch.ones_like(cid, dtype=torch.int32))
    start = torch.cumsum(count, dim=-1, dtype=torch.int32) - count
    return order, start, count
