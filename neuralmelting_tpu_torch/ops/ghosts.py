"""Ghost (periodic-image) atoms for neighbour-free pair energies
(counterpart of ``neuralmelting_tpu.ops.ghosts``), over a leading replica
axis.

The dense engine takes each trial energy against ALL atoms through

    r^2_mj = |r_m|^2 - 2 r_m . p_j + |p_j|^2,

which is exact only without minimum-image wrapping. Ghost copies of every
atom within ``shell`` of a periodic face, edge or corner (up to 7 of the
26 images) extend the position array, so that every interacting pair has
an unwrapped image within rc and no distance needs wrapping.

Ghosts carry their parent index; an accepted mover updates its own row
and its ghost rows in one scatter. Staleness follows the displacement
criterion of the neighbour lists; unused ghost capacity is parked at
1e30, so padded rows never interact.

Every selection equals the JAX package's bit for bit: the first ``gcap``
active (image, atom) entries in offset-major order (the JAX ``top_k`` of
the 0/1 mask, lower index first among ties) are found by a search of the
running count over the mask, and a ghost's rank among its parent's
ghosts, which the JAX build takes from an O(gcap^2) pair table, is the
exclusive running count of the mask along the image axis at (image,
parent), O(26 N). Sums of three squares are the multiply-adds XLA's CPU
backend contracts them into (``jrandom.fma32``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neuralmelting_tpu_torch.ops.jrandom import fma32

GCAP_PER_ATOM = 7  # the 7-image worst case (a corner atom)


@dataclasses.dataclass
class GhostMap:
    """Extended positions of an ensemble. Extended index space: [0, N)
    real atoms, [N, N + gcap) ghosts."""
    pos_ext: torch.Tensor     # (R, N+gcap, 3); unused ghost rows at 1e30
    parent_ext: torch.Tensor  # (R, N+gcap) int32; real rows their index,
                              #   unused ghost rows -1
    sign: torch.Tensor        # (R, gcap, 3) f32 image signs of each slot
    slots_of: torch.Tensor    # (R, N, GCAP_PER_ATOM) int32 extended slots
                              #   of each atom's ghosts, padded with N+gcap
    nghost: torch.Tensor      # (R,) int32 active images (may be > gcap)
    ref_pos: torch.Tensor     # (R, N, 3) positions at build
    ref_box: torch.Tensor     # (R, 3)
    shell: torch.Tensor       # (R,) f32 shell width
    overflow: torch.Tensor    # (R,) bool: capacity or image slots exceeded

    @property
    def gcap(self) -> int:
        return self.sign.shape[-2]

    @property
    def natoms(self) -> int:
        return self.ref_pos.shape[-2]

    def replace(self, **kw) -> "GhostMap":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(GhostMap))


def suggest_gcap(n, box_host, shell, safety=1.4):
    """Static ghost capacity from the shell volume fraction."""
    box = np.asarray(box_host, np.float64)
    frac = float(np.prod(box + 2 * shell) / np.prod(box) - 1.0)
    g = int(np.ceil(safety * n * frac)) + 32
    return (g + 127) // 128 * 128


def _f32(v, like):
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _image_signs(device) -> torch.Tensor:
    """The 26 neighbour-image sign vectors (26, 3) f32 in the JAX order
    (sx, sy, sz each over -1, 0, 1, without (0, 0, 0)), made on the
    device (no host copy, so a CUDA graph can capture a build)."""
    k = torch.arange(26, device=device)
    k = k + (k >= 13).long()          # skip (0, 0, 0), the 13th of 27
    return torch.stack([k // 9, k // 3 % 3, k % 3], -1).float() - 1.0


def sq_sum3(v):
    """v_x^2 + v_y^2 + v_z^2 over the last axis, as XLA's CPU backend
    fuses it: fma(z, z, fma(y, y, x x))."""
    x, y, z = v.unbind(-1)
    return fma32(z, z, fma32(y, y, x * x))


def build(pos, box, shell, gcap: int) -> GhostMap:
    """Select ghosts for positions ``pos`` (R, N, 3) inside boxes ``box``
    (R, 3): atom i has an image for sign s iff for every axis c with
    s_c = +1, x_c < shell, and with s_c = -1, x_c > L_c - shell."""
    r, n, _ = pos.shape
    dev = pos.device
    sh = _f32(shell, pos)
    signs = _image_signs(dev)                                # (26, 3)
    lo = pos[:, None, :, :] < sh                            # (R, 1, N, 3)
    hi = pos[:, None, :, :] > (box - sh)[:, None, None, :]
    s = signs[None, :, None, :]
    ok = torch.where(s > 0, lo, torch.where(s < 0, hi, True))
    mask = torch.all(ok, dim=-1)                            # (R, 26, N)
    flat = mask.reshape(r, -1)
    count = flat.sum(dim=1, dtype=torch.int32)
    # the first gcap active entries in flat (offset-major) order: the
    # (g+1)-th active entry is where the running count first reaches g+1
    g_ids = torch.arange(gcap, device=dev)
    valid = g_ids[None, :] < count[:, None]                 # (R, gcap)
    idx = torch.searchsorted(torch.cumsum(flat, dim=1),
                             (g_ids + 1).expand(r, -1).contiguous())
    idx = torch.where(valid, idx, 0)
    off_id = idx // n
    parent = torch.where(valid, idx % n, 0)
    sign = torch.where(valid[..., None], signs[off_id], 0.0)

    gpos = pos.gather(1, parent[..., None].expand(-1, -1, 3)) \
        + sign * box[:, None, :]
    gpos = torch.where(valid[..., None], gpos, 1e30)
    pos_ext = torch.cat([pos, gpos], dim=1)
    parent_ext = torch.cat(
        [torch.arange(n, dtype=torch.int32, device=dev).expand(r, -1),
         torch.where(valid, parent, -1).to(torch.int32)], dim=1)

    # rank of a ghost among its parent's: its parent's active images at
    # lower offsets (each one selected too, since selection keeps a
    # prefix of the flat order)
    before = torch.cumsum(mask, dim=1, dtype=torch.int32) - mask.to(
        torch.int32)
    rank = before.reshape(r, -1).gather(1, idx)             # (R, gcap)
    # an atom needs more than 7 images only when 2 shell > min(box) (it
    # lies within shell of both faces of an axis): flag it
    rank_overflow = torch.any(valid & (rank > GCAP_PER_ATOM - 1), dim=1)
    rank = torch.clamp(rank, max=GCAP_PER_ATOM - 1)
    dump = n + gcap
    # where clamped ranks collide, the last ghost wins, as in XLA's
    # in-order scatter; an unused slot g goes to a place of its own past
    # the table (no two writes to one place but those collisions)
    slot = torch.where(valid, parent * GCAP_PER_ATOM + rank,
                       n * GCAP_PER_ATOM + g_ids)
    table = torch.full((r, n * GCAP_PER_ATOM + gcap), -1, dtype=torch.int64,
                       device=dev)
    table.scatter_reduce_(1, slot, (n + g_ids).expand(r, -1).contiguous(),
                          "amax")
    table = torch.where(table < 0, dump, table)
    slots_of = table[:, :n * GCAP_PER_ATOM].reshape(
        r, n, GCAP_PER_ATOM).to(torch.int32)
    return GhostMap(
        pos_ext=pos_ext, parent_ext=parent_ext, sign=sign,
        slots_of=slots_of, nghost=count, ref_pos=pos.clone(),
        ref_box=box.clone(), shell=sh.expand(r).clone(),
        overflow=(count > gcap) | rank_overflow)


def needs_rebuild(gm: GhostMap, rc, budget=0.0, shrink=1.0):
    """(R,) bool: True where accumulated displacement may break image
    coverage: rc / shrink + 2 (maxdisp + budget) > shell, with maxdisp
    over the real rows since the build. ``budget`` is displacement
    headroom the caller consumes before the next check (one checkerboard
    move is sqrt(3) dpos); ``shrink`` (< 1) budgets a pending isotropic
    rescale by it. ``budget`` and ``shrink`` may be tensors."""
    return stale(gm.pos_ext, gm.ref_pos, gm.shell, rc, budget, shrink)


def stale(pos_ext, ref_pos, shell, rc, budget=0.0, shrink=1.0):
    """``needs_rebuild`` on the tensors."""
    d = pos_ext[:, :ref_pos.shape[1]] - ref_pos
    maxdisp = torch.sqrt(torch.max(sq_sum3(d), dim=-1).values)
    # a tensor numerator: a host number over a tensor would be taken as
    # its reciprocal times the number
    return (_f32(rc, d) / shrink + 2.0 * (maxdisp + budget)) > shell


def scaled(gm: GhostMap, s) -> GhostMap:
    """An isotropic rescale by ``s`` (R,) of every extended position."""
    s3 = s[:, None, None]
    return gm.replace(pos_ext=gm.pos_ext * s3, ref_pos=gm.ref_pos * s3,
                      ref_box=gm.ref_box * s[:, None], shell=gm.shell * s)


def apply_moves(gm: GhostMap, ids, delta) -> GhostMap:
    """Add accepted displacements ``delta`` (R, A, 3), zero for rejected
    movers, into the real rows ``ids`` (R, A) and their ghost rows.
    Positions are NOT wrapped: unwrapped coordinates plus ghosts keep the
    pair math exact between rebuilds (a rebuild wraps). The table's
    padding slot adds nothing (its index is masked to row 0, with a zero
    displacement)."""
    return gm.replace(pos_ext=move_rows(gm.pos_ext, gm.slots_of, ids, delta))


def move_rows(pos_ext, slots_of, ids, delta):
    """``apply_moves`` on the tensors: the new extended positions."""
    r, a = ids.shape
    ids = ids.long()
    slots = slots_of.gather(1, ids[..., None].expand(
        -1, -1, GCAP_PER_ATOM)).long()                       # (R, A, 7)
    rows = torch.cat([ids[..., None], slots], dim=2)        # (R, A, 8)
    keep = rows < pos_ext.shape[1]
    rows = torch.where(keep, rows, 0).reshape(r, -1, 1).expand(-1, -1, 3)
    add = torch.where(keep[..., None], delta[:, :, None, :], 0.0)
    return pos_ext.scatter_add(1, rows, add.reshape(r, -1, 3))


def wrap(pos, box):
    """Positions (R, N, 3) wrapped into their boxes (R, 3)."""
    b = box[:, None, :]
    return pos - b * torch.floor(pos / b)


def rewrap_rebuild(gm: GhostMap, box, shell, gcap: int) -> GhostMap:
    """Wrap the real rows back into the box and rebuild the ghosts."""
    return build(wrap(gm.pos_ext[:, :gm.natoms], box), box, shell, gcap)
