"""Fixed-capacity neighbour lists over a leading replica axis
(counterpart of ``neuralmelting_tpu.ops.neighbors``).

The list is built by an O(N^2) masked pass, blocked over replicas and
rows so a block's distance tile stays near ``tile`` elements (the
temporaries of R = 64 replicas of 4096 atoms at once would take GBs).
Each row keeps the FIRST ``capacity`` in-range columns in index order,
as the JAX ``lax.top_k`` of the 0/1 mask gives them: here a running
count over the mask ranks the in-range columns and a scatter puts them
in place, so ``idx`` and ``count`` equal the JAX package's. Static
capacity K keeps every shape fixed; overflow and staleness are flags,
and rebuilds are global (all replicas at once: parallel/ensemble.py).

Safety invariant: every pair currently within rc must appear in the
list. With rlist = rc + skin at build, the box rescaled by s since the
build, and maximum effective displacement D (against the affinely
rescaled build positions), it holds while rc + 2 D <= rlist min(s).

Pair terms take the JAX functions' f32 operations in torch's summation
order, so energies, virials and forces agree with JAX to f32 rounding
(XLA on the CPU also contracts r^2 into multiply-adds).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neuralmelting_tpu_torch.ops.energy import min_image


def _mi(d, length):
    """Minimum image, one component."""
    return d - length * torch.round(d / length)


@dataclasses.dataclass
class NeighborList:
    idx: torch.Tensor       # (R, N, K) int64, padded with the self index
    count: torch.Tensor     # (R, N) int32 in-range neighbours (may be > K)
    ref_pos: torch.Tensor   # (R, N, 3) positions at build
    ref_box: torch.Tensor   # (R, 3) box at build
    rlist: torch.Tensor     # (R,) rc + skin at build, f32
    overflow: torch.Tensor  # (R,) bool: capacity exceeded, list unusable

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


def suggest_capacity(n, box, rlist, safety=1.6, cap_min=16):
    """Static neighbour capacity from the build-time density (+ margin)."""
    rho = n / float(np.prod(np.asarray(box, np.float64)))
    k = int(np.ceil(safety * rho * (4.0 / 3.0) * np.pi * float(rlist) ** 3))
    k = max(cap_min, k)
    k = int((k + 7) // 8 * 8)
    return min(k, n - 1)  # can't have more neighbors than n-1


def f32_rlist(rc, skin) -> float:
    """rc + skin rounded as the JAX package's f32 ``pot.rc + skin``."""
    return float(np.float32(rc) + np.float32(skin))


def build(pos, box, rlist: float, capacity: int,
          tile: int = 1 << 24) -> NeighborList:
    """Masked O(N^2) build of every replica's list. pos (R, N, 3), box
    (R, 3), rlist an f32 value (``f32_rlist``)."""
    r, n = pos.shape[:2]
    dev = pos.device
    rlist2 = float(np.float32(rlist) * np.float32(rlist))
    rows = min(n, max(8, tile // n))
    reps = max(1, tile // (rows * n))
    idx = torch.empty((r, n, capacity), dtype=torch.int64, device=dev)
    count = torch.empty((r, n), dtype=torch.int32, device=dev)
    cols = torch.arange(n, device=dev)
    slot_cap = torch.full((), capacity, dtype=torch.int64, device=dev)
    for r0 in range(0, r, reps):
        rb = slice(r0, min(r, r0 + reps))
        p = pos[rb]
        bx = box[rb][:, None, None, :]
        for i0 in range(0, n, rows):
            i1 = min(n, i0 + rows)
            pi = p[:, i0:i1]
            dx = _mi(pi[:, :, None, 0] - p[:, None, :, 0], bx[..., 0])
            dy = _mi(pi[:, :, None, 1] - p[:, None, :, 1], bx[..., 1])
            dz = _mi(pi[:, :, None, 2] - p[:, None, :, 2], bx[..., 2])
            r2 = dx * dx + dy * dy + dz * dz                 # (rb, B, N)
            notself = cols[None, :] != torch.arange(i0, i1, device=dev)[:, None]
            mask = (r2 < rlist2) & notself
            count[rb, i0:i1] = mask.sum(-1, dtype=torch.int32)
            # rank of each in-range column; the first K go to their slots,
            # the rest to a spare slot K that is dropped
            rank = torch.cumsum(mask, dim=-1) - 1
            dest = torch.where(mask, torch.minimum(rank, slot_cap), slot_cap)
            out = torch.arange(i0, i1, device=dev)[None, :, None].expand(
                pi.shape[0], -1, capacity + 1).clone()
            out.scatter_(2, dest, cols.expand_as(dest))
            idx[rb, i0:i1] = out[..., :capacity]
    return NeighborList(
        idx=idx, count=count, ref_pos=pos.clone(), ref_box=box.clone(),
        rlist=torch.full((r,), rlist, dtype=torch.float32, device=dev),
        overflow=torch.any(count > capacity, dim=-1))


def max_displacement(nl: NeighborList, pos, box):
    """(R,) max effective displacement vs. affinely rescaled build
    positions."""
    s = box / nl.ref_box
    d = min_image(pos - nl.ref_pos * s[:, None, :], box[:, None, :])
    return torch.sqrt(torch.max(torch.sum(d * d, dim=-1), dim=-1).values)


def needs_rebuild(nl: NeighborList, pos, box, rc, budget=0.0, shrink=1.0):
    """(R,) bool: True where the safety invariant may no longer hold.

    ``budget`` is extra per-particle displacement headroom the caller will
    consume BEFORE the next staleness check (e.g. sqrt(3) dpos for one
    more checkerboard move per particle); ``shrink`` (<1) budgets a
    pending isotropic box rescale.
    """
    s = box / nl.ref_box
    maxdisp = max_displacement(nl, pos, box)
    return (rc + 2.0 * (maxdisp + budget)) > \
        nl.rlist * torch.min(s, dim=-1).values * shrink


def _row_terms(pot, pos, box, idx, count, centres):
    """Pair energies/virials of central particles against their list rows,
    with the displacement components.

    idx (R, ..., K) neighbour rows, count (R, ...) their counts and
    centres (R, ..., 3) the central particles' coordinates, broadcasting
    against each other over the middle axes. The neighbours' coordinates
    come from one gather. Returns e, w, dx, dy, dz, r2, valid, each
    (R, ..., K).
    """
    _, rc2, _, _ = pot.f32_consts()
    r = pos.shape[0]
    g = pos.gather(1, idx.reshape(r, -1, 1).expand(-1, -1, 3)).reshape(
        *idx.shape, 3)
    lbox = box.reshape((r,) + (1,) * (idx.dim() - 1) + (3,))
    dx, dy, dz = _mi(centres[..., None, :] - g, lbox).unbind(-1)
    r2 = dx * dx + dy * dy + dz * dz
    slot = torch.arange(idx.shape[-1], device=idx.device)
    valid = (slot < count[..., None]) & (r2 < rc2)
    e, w = pot.pair_e_w(torch.where(valid, r2, 1.0))
    return (torch.where(valid, e, 0.0), torch.where(valid, w, 0.0),
            dx, dy, dz, r2, valid)


def pair_energy_virial(pot, pos, box, nl: NeighborList):
    """(R,) total pe and virial from the lists (each pair appears twice:
    x 0.5)."""
    e, w, *_ = _row_terms(pot, pos, box, nl.idx, nl.count, pos)
    return 0.5 * e.sum(dim=(-2, -1)), 0.5 * w.sum(dim=(-2, -1))


def forces(pot, pos, box, nl: NeighborList):
    """(R, N, 3) pair forces f_i = sum_j (w / r^2) (r_i - r_j)."""
    e, w, dx, dy, dz, r2, valid = _row_terms(pot, pos, box, nl.idx,
                                             nl.count, pos)
    coef = torch.where(valid, w / torch.where(valid, r2, 1.0), 0.0)
    return torch.stack([(coef * dx).sum(-1), (coef * dy).sum(-1),
                        (coef * dz).sum(-1)], dim=-1)


def delta_moves(pot, pos, box, nl: NeighborList, ids, new_r):
    """Batched (dE, dW), each (R, M), for moving particles ``ids`` (R, M)
    to ``new_r`` (R, M, 3).

    Exact provided the moved particles are pairwise non-interacting
    (checkerboard guarantee) and the list is fresh (needs_rebuild False).
    The old and new positions are evaluated as one (R, 2, M, K) block.
    """
    rows = nl.idx.gather(1, ids[..., None].expand(-1, -1, nl.capacity))
    cnt = nl.count.gather(1, ids)
    old = pos.gather(1, ids[..., None].expand(-1, -1, 3))
    e, w, *_ = _row_terms(pot, pos, box, rows[:, None], cnt[:, None],
                          torch.stack([old, new_r], dim=1))
    e, w = e.sum(-1), w.sum(-1)
    return e[:, 1] - e[:, 0], w[:, 1] - w[:, 0]


def delta_move_single(pot, pos, box, nl, i, new_ri):
    """One mover a replica: atom ``i`` (R,) to ``new_ri`` (R, 3) -> (dE,
    dW), each (R,); the EnergyBackend.delta_move API."""
    de, dw = delta_moves(pot, pos, box, nl, i[:, None], new_ri[:, None])
    return de[:, 0], dw[:, 0]
