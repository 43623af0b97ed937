"""Slab geometry and the slab-resident state helpers (plain torch).

Counterpart of the geometry and XLA-side helpers of
``neuralmelting_tpu/ops/pallas/cellmc.py``: ``CellGeom``, ``make_geom``,
``tight_kcap``, ``geom_tables``, ``_scid``, ``bin_initial``, ``unbin``,
``_shift_cells_up`` and ``rebin_axis``. Bin, unbin and rebin reproduce the
JAX results bit for bit, ids included: ``jax.lax.sort`` is stable, and
here it is ``torch.sort(stable=True)`` plus a gather of every operand.

Layout ("slabs"): positions live binned as (R, C*K) tensors per
coordinate — R replicas, C cells in colour-major order (stride^3 colours x
the (hx, hy, hz) within-colour grid), K slots per cell with the occupied
slots packed first, empty slots parked at ``INVALID``. Coordinates are in
the SHIFTED frame, y = ((x/L + shift) mod 1) L, so every cell is the
axis-aligned block [c w, (c+1) w). ``bin_initial`` and ``unbin`` take the
whole ensemble at once (the JAX versions are vmapped per replica).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

INVALID = 1.0e30        # parked coordinate for empty slots


@dataclasses.dataclass(frozen=True)
class CellGeom:
    """Static slab geometry: cells of width >= rc, checkerboard stride s
    (s=2 for pair potentials: same-colour movers cannot interact; s=3 for
    EAM: same-colour movers 2w >= 2rc apart have disjoint neighbourhoods,
    so their density-coupled acceptances stay exact in parallel). Each
    axis count is divisible by s, so colours tile periodically."""
    ncell: tuple            # (nx, ny, nz), each divisible by stride
    kcap: int               # slots per cell (multiple of 8)
    nsub: int               # J: mover picks per cell per colour step
    natoms: int
    stride: int = 2

    @property
    def ncolors(self) -> int:
        return self.stride ** 3

    @property
    def ncells(self) -> int:
        return int(np.prod(self.ncell))

    @property
    def half(self) -> tuple:             # within-colour grid
        return tuple(n // self.stride for n in self.ncell)

    @property
    def cw(self) -> int:                 # cells per colour
        return self.ncells // self.ncolors

    @property
    def rows(self) -> int:
        return self.ncells * self.kcap


def make_geom(box0, rc: float, natoms: int, nsub: int = 16,
              shrink_margin: float = 0.05, kcap: int = 0,
              stride: int = 2) -> CellGeom:
    """Cell grid for initial box ``box0``: per axis the largest
    stride-divisible cell count with width >= rc/(1-shrink_margin) (the
    margin budgets NPT box shrink within a chunk; the engine flags a cell
    width below rc with DIAG_CB_INVALID)."""
    box0 = np.asarray(box0, np.float64)
    wmin = float(rc) / (1.0 - shrink_margin)
    ncell = []
    for b in box0:
        n = int(np.floor(b / wmin))
        n = max(stride, (n // stride) * stride)
        if b / n < wmin:
            raise ValueError(
                f"box {box0} too small for cell MC at rc={rc} "
                f"(need >= {stride * wmin} per axis)")
        ncell.append(n)
    ncell = tuple(ncell)
    if kcap <= 0:
        dens = natoms / float(np.prod(box0))
        cellvol = float(np.prod(box0 / np.asarray(ncell)))
        mean = dens * cellvol
        # occupancy fluctuations in a condensed phase are sub-Poisson;
        # overflow is detected at run time (DIAG_SLAB_OVERFLOW) and retried
        kcap = int(np.ceil(mean + max(2.5 * np.sqrt(mean), 6.0)))
    kcap = max(kcap, nsub)
    # multiple of 8, as the JAX total kernel requires (its mover chunks)
    kcap = -(-kcap // 8) * 8
    return CellGeom(ncell=ncell, kcap=kcap, nsub=nsub, natoms=natoms,
                    stride=stride)


def tight_kcap(maxcount: int, nsub: int = 8, margin: int = 12) -> int:
    """Slot capacity from MEASURED occupancy: max cell count + margin,
    rounded up to 8. Sweep work is linear in K (27 K candidate pairs per
    trial); overflow is detected and the runner retries with K+8."""
    k = max(maxcount + margin, nsub, 8)
    return -(-k // 8) * 8


def geom_tables(geom: CellGeom):
    """Per-row full-cell coordinates, (3, C*K) int32 numpy."""
    s = geom.stride
    hx, hy, hz = geom.half
    k = geom.kcap
    rows = np.arange(geom.rows)
    cell = rows // k
    color = cell // geom.cw
    w = cell % geom.cw
    sx, sy, sz = color // (s * s), (color // s) % s, color % s
    vx, vy, vz = w // (hy * hz), (w // hz) % hy, w % hz
    return np.stack([s * vx + sx, s * vy + sy,
                     s * vz + sz]).astype(np.int32)


def scid(geom: CellGeom, c3):
    """Colour-major slab cell index from full-cell coords (..., 3)
    (numpy or torch integers)."""
    s = geom.stride
    hx, hy, hz = geom.half
    cx, cy, cz = c3[..., 0], c3[..., 1], c3[..., 2]
    color = ((cx % s) * s + (cy % s)) * s + (cz % s)
    w = ((cx // s) * hy + (cy // s)) * hz + (cz // s)
    return color * geom.cw + w


def offsets26():
    return [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if (dx, dy, dz) != (0, 0, 0)]


def offsets13():
    """Half-space offsets: each unordered cell pair appears once across
    (cell, offset) (lexicographically positive)."""
    return [d for d in offsets26()
            if d[0] > 0 or (d[0] == 0 and (d[1] > 0 or
                                           (d[1] == 0 and d[2] > 0)))]


@functools.lru_cache(maxsize=None)
def _stencil_np(ncell: tuple, stride: int, offs: tuple):
    geom = CellGeom(ncell=ncell, kcap=1, nsub=1, natoms=0, stride=stride)
    cfull = geom_tables(geom).T.astype(np.int64)          # (C, 3)
    d = np.asarray(offs, np.int64)                       # (O, 3)
    n = cfull[:, None, :] + d[None, :, :]                # (C, O, 3)
    nc = np.asarray(ncell, np.int64)
    img = np.where(n >= nc, 1, np.where(n < 0, -1, 0))   # wrapped image
    nb = scid(geom, n - img * nc)                        # (C, O)
    return cfull, nb, img


def stencil(geom: CellGeom, offs, device):
    """Neighbour tables of every slab cell for the offsets ``offs``.

    Returns (cfull (C, 3) full-cell coords, nb (C, O) slab cell index of
    the neighbour, img (C, O, 3) in {-1, 0, 1}: the periodic image the
    neighbour is seen at, i.e. its coordinates are read plus img * L)."""
    cfull, nb, img = _stencil_np(tuple(geom.ncell), geom.stride,
                                 tuple(tuple(o) for o in offs))
    return (torch.as_tensor(cfull, device=device),
            torch.as_tensor(nb, device=device),
            torch.as_tensor(img, device=device))


# ---------------------------------------------------------------------------
# bin / rebin / unbin
# ---------------------------------------------------------------------------

def bin_initial(geom: CellGeom, pos, box, shift):
    """pos (R, N, 3) original frame -> slabs, for the whole ensemble.

    Returns (x, y, z, ids, count, overflow): coords (R, C*K) f32 in the
    shifted frame, ids (R, C*K) int32 with -1 padding, count (R, C) int32,
    overflow a bool tensor (some cell holds more than K atoms: the rank is
    then clipped to K-1 and atoms are lost, so the caller must rebin).
    """
    r, n, _ = pos.shape
    k = geom.kcap
    dev = pos.device
    ncell_i = torch.tensor(geom.ncell, dtype=torch.int32, device=dev)
    ncell_f = torch.tensor(geom.ncell, dtype=torch.float32, device=dev)
    bx = box[:, None, :]
    y = torch.remainder(pos / bx + shift, 1.0) * bx
    w = bx / ncell_f
    c3 = torch.minimum((y / w).to(torch.int32), ncell_i - 1)
    cell = scid(geom, c3).to(torch.int64)                 # (R, N)
    s, order = torch.sort(cell, dim=1, stable=True)
    ys = torch.gather(y, 1, order[:, :, None].expand(r, n, 3))
    ids = order.to(torch.int32)
    count = torch.zeros((r, geom.ncells), dtype=torch.int32, device=dev)
    count.scatter_add_(1, s, torch.ones_like(s, dtype=torch.int32))
    iota = torch.arange(n, device=dev).expand(r, n)
    boundary = torch.ones_like(s, dtype=torch.bool)
    boundary[:, 1:] = s[:, 1:] != s[:, :-1]
    seg_start = torch.cummax(torch.where(boundary, iota, 0), dim=1).values
    rank = iota - seg_start
    rows = s * k + torch.clamp(rank, max=k - 1)
    out = []
    for a in range(3):
        sl = torch.full((r, geom.rows), INVALID, dtype=torch.float32,
                        device=dev)
        out.append(sl.scatter_(1, rows, ys[:, :, a]))
    idsl = torch.full((r, geom.rows), -1, dtype=torch.int32, device=dev)
    idsl.scatter_(1, rows, ids)
    return out[0], out[1], out[2], idsl, count, torch.any(count > k)


def unbin(geom: CellGeom, slabs, box, shift):
    """slabs (x, y, z, ids) (R, C*K) -> (R, N, 3) positions in the
    ORIGINAL frame, atom-id order."""
    x, y, z, ids = slabs[:4]
    key = torch.where(ids >= 0, ids, geom.rows + 1)
    _, order = torch.sort(key, dim=1, stable=True)
    n = geom.natoms
    order = order[:, :n]
    yy = torch.stack([torch.gather(c, 1, order) for c in (x, y, z)], dim=-1)
    bx = box[:, None, :]
    return torch.remainder(yy / bx - shift, 1.0) * bx


def _cellgrid(geom: CellGeom, arr):
    """(..., C, K) -> (..., s,s,s, hx,hy,hz, K) colour-major view."""
    s = geom.stride
    hx, hy, hz = geom.half
    return arr.reshape(arr.shape[:-2] + (s, s, s, hx, hy, hz, geom.kcap))


def shift_cells_up(geom: CellGeom, arr, axis: int):
    """out[c] = in[c - 1] along full-cell ``axis`` (periodic); arr
    (..., C, K). The donor view for rebinning."""
    g = _cellgrid(geom, arr)
    s = geom.stride
    sa = g.dim() - 7 + axis      # colour-bit axis in the 8-D view
    va = g.dim() - 4 + axis      # within-colour axis
    # c-1 of (sigma=j>0, v) is (sigma=j-1, v); c-1 of (sigma=0, v) is
    # (sigma=s-1, v-1): roll the top colour by one v step
    parts = [g.narrow(sa, j, 1) for j in range(s)]
    out = torch.cat([torch.roll(parts[s - 1], 1, dims=va)] + parts[:s - 1],
                    dim=sa)
    return out.reshape(arr.shape)


@functools.lru_cache(maxsize=None)
def _static_cell_axis_np(ncell, kcap, stride, axis):
    geom = CellGeom(ncell=ncell, kcap=kcap, nsub=1, natoms=0, stride=stride)
    return geom_tables(geom)[axis]


def rebin_axis(geom: CellGeom, slabs, count, box, delta_frac, axis: int,
               cell_tab=None, extras=()):
    """Advance the grid shift by ``delta_frac`` (< 1/ncell[axis]) along one
    axis: every atom stays in its cell or moves to the cell BELOW it (its
    cell index grows by one as the grid slides). (R, C*K) slabs -> new
    slabs, one stable sort along the 2K axis of (stay | donor) blocks.

    Returns (slabs, count, overflow), and a tuple of the re-sorted
    ``extras`` as a fourth item when any are given: per-slot (R, C*K)
    float data that travels with its atom (the EAM density slab), 0 in
    empty slots. The caller advances its shift: shift[axis] += delta_frac.
    ``count`` is unused (the JAX signature).
    """
    x, y, z, ids = slabs
    r = x.shape[0]
    c, k = geom.ncells, geom.kcap
    la = box[:, axis:axis + 1]                       # (R, 1)
    na = geom.ncell[axis]
    coord = (x, y, z)[axis]
    valid = ids >= 0
    moved = torch.remainder(coord + delta_frac * la, la)
    coord2 = torch.where(valid, moved, INVALID)
    slabs2 = [coord2 if a == axis else s for a, s in enumerate((x, y, z))]
    wa = la / na
    # empty slots are excluded by `valid` below; dividing a zero there
    # keeps the float->int conversion in range
    newc = torch.clamp(
        (torch.where(valid, coord2, 0.0) / wa).to(torch.int32), max=na - 1)
    if cell_tab is None:
        cell_tab = torch.as_tensor(
            _static_cell_axis_np(tuple(geom.ncell), k, geom.stride, axis),
            device=x.device)
    stays = valid & (newc == cell_tab[None, :])
    goes = valid & ~stays

    def blocks(v, fill):
        stay = torch.where(stays, v, fill).reshape(r, c, k)
        mover = torch.where(goes, v, fill).reshape(r, c, k)
        donor = shift_cells_up(geom, mover, axis)
        return torch.cat([stay, donor], dim=-1)      # (R, C, 2K)

    bx = blocks(slabs2[0], INVALID)
    by = blocks(slabs2[1], INVALID)
    bz = blocks(slabs2[2], INVALID)
    bi = blocks(ids, -1)
    keyf = torch.where(bi >= 0, 0.0, 1.0)
    _, order = torch.sort(keyf, dim=2, stable=True)
    order = order[..., :k]
    sort = lambda a: torch.gather(a, 2, order).reshape(r, c * k)
    out = tuple(sort(a) for a in (bx, by, bz, bi))
    nvalid = torch.sum((bi >= 0).to(torch.int32), dim=-1)   # (R, C)
    overflow = torch.any(nvalid > k)
    count = torch.clamp(nvalid, max=k).to(torch.int32)
    if extras:
        return out, count, overflow, tuple(sort(blocks(e, 0.0))
                                           for e in extras)
    return out, count, overflow
