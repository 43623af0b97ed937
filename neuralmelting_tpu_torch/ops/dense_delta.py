"""Trial-move and total LJ energies against every extended position
(counterpart of ``neuralmelting_tpu.ops.dense_delta``), over a leading
replica axis.

The hot object is r^2 between A rows and ALL extended positions
(ops/ghosts.py):

    r2[m, j] = |r_m|^2 - 2 r_m . p_j + |p_j|^2
             = [x_m, y_m, z_m, 1] @ [-2 p_j ; |p_j|^2]  + |r_m|^2,

one (A, 4) @ (4, N + gcap) product a side, with the LJ evaluation and the
row sums after it. With |p|^2 up to ~800 sigma^2 the cancellation needs
IEEE f32 products: one bf16 pass gave pe/N +9 instead of -6.9 in the JAX
package, which forces ``Precision.HIGHEST``, and TF32 would do the same
damage. So the port forms the four terms itself, in f32 whatever torch's
matmul precision is, and adds them in the order XLA's CPU dot adds them
for these shapes: x q_x, then a multiply-add each of y q_y and z q_z
(rounded once, ``jrandom.fma32``), then |p|^2, then |r|^2 (|p|^2 and
|r|^2 themselves as XLA fuses them, ``ghosts.sq_sum3``). So r^2 equals the
JAX value bit for bit; the row sums are taken in torch's order, and
energies agree with the JAX ones to f32 rounding.

On CUDA tensors the totals' row sums run through ``torch.compile`` (one
kernel a block of rows: the (R, rows, N + gcap) terms are never stored),
and the dense pass compiles its whole colour substep
(``sampler/dense.py``); on CPU tensors they run eagerly, in blocks of
rows.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.ops.ghosts import sq_sum3
from neuralmelting_tpu_torch.ops.jrandom import fma32

_COMPILED = {}


def _q_matrix(pos_ext):
    """(R, 4, Next): rows [-2x; -2y; -2z; |p|^2]."""
    p2 = sq_sum3(pos_ext)
    return torch.cat([-2.0 * pos_ext.transpose(1, 2), p2[:, None, :]], dim=1)


def _r2(q, r):
    """(R, A, Next) squared distances of the rows ``r`` (R, A, 3) to the
    columns of ``q`` (``_q_matrix``), in XLA's order (module docstring)."""
    x, y, z = (r[..., k:k + 1] for k in range(3))
    qx, qy, qz, p2 = (q[:, k:k + 1, :] for k in range(4))
    dot = fma32(z, qz, fma32(y, qy, x * qx)) + p2
    return dot + sq_sum3(r)[..., None]


def _lj_rowsum(pot, r2, interact, with_virial=True):
    """Row sums of e (and w, else None) over the pairs where ``interact``
    and r2 < rc^2, sr2 = sigma^2 / max(r2, 1e-4)."""
    sig2, rc2, e4, w24 = pot.f32_consts()
    sr2 = r2.new_full((), sig2) / torch.clamp(r2, min=1e-4)
    sr6 = sr2 * sr2 * sr2
    sr12 = sr6 * sr6
    valid = interact & (r2 < rc2)
    e = torch.where(valid, e4 * (sr12 - sr6), 0.0).sum(-1)
    if not with_virial:
        return e, None
    return e, torch.where(valid, w24 * (2.0 * sr12 - sr6), 0.0).sum(-1)


def row_sums(pot, q, parent_ext, r, ids, with_virial=True):
    """Row sums (R, A) of e and w (else None) of the rows ``r`` (R, A, 3)
    against every column of ``q`` but their own images (parent ``ids``
    (R, A))."""
    not_self = parent_ext[:, None, :] != ids[..., None]
    return _lj_rowsum(pot, _r2(q, r), not_self, with_virial)


def compiled(fn):
    """``fn`` through ``torch.compile``, for CUDA tensors (compiled at the
    first call with each shape, in this process, with no pool of compile
    workers)."""
    if fn not in _COMPILED:
        import torch._dynamo.config as dynamo_config
        dynamo_config.recompile_limit = max(dynamo_config.recompile_limit,
                                            64)
        _COMPILED[fn] = torch.compile(fn, fullgraph=True, dynamic=False,
                                      options={"compile_threads": 1})
    return _COMPILED[fn]


def _row_sums_fn(pos):
    """``row_sums``, compiled for CUDA tensors."""
    return compiled(row_sums) if pos.is_cuda else row_sums


def delta_moves_dense(pot, gm, ids, old_r, new_r, with_virial=False):
    """(dE, dW) (R, A) for movers ``ids`` (R, A) from ``old_r`` to
    ``new_r`` (R, A, 3), unwrapped coordinates, against the whole
    extended set. Exact when the movers are pairwise >= rc + 2 dpos apart
    (checkerboard). Without ``with_virial`` dW is zero (the run function
    refreshes the virial at every record)."""
    return delta_rows(pot, gm.pos_ext, gm.parent_ext, ids, old_r, new_r,
                      with_virial)


def delta_rows(pot, pos_ext, parent_ext, ids, old_r, new_r,
               with_virial=False):
    """``delta_moves_dense`` on the tensors, both sides' rows in one
    ``row_sums`` call (eager: the dense pass compiles its whole colour
    substep around it)."""
    a = ids.shape[1]
    e, w = row_sums(pot, _q_matrix(pos_ext), parent_ext,
                torch.cat([old_r, new_r], dim=1), torch.cat([ids, ids], 1),
                with_virial)
    de = e[:, a:] - e[:, :a]
    if not with_virial:
        return de, torch.zeros_like(de)
    return de, w[:, a:] - w[:, :a]


def default_row_block(r: int, natoms: int, next_: int, cuda: bool) -> int:
    """Rows a block: a block's (R, rows, Next) terms stay near 2^24
    elements where they are stored (eager, a few hundred MB) and near
    2^28 where they are not (compiled, on the card); at least 8."""
    budget = 1 << (28 if cuda else 24)
    return min(natoms, max(8, budget // max(1, r * next_)))


def total_energy_virial_dense(pot, gm, row_block: int = 0):
    """Total pe and virial (R,) of the real atoms against the extended
    set, blocked over rows (``row_block`` 0: ``default_row_block``); the
    rows split into equal blocks, the last padded with rows at 1e30 that
    interact with nothing, as in the JAX package.

    Each (real, real) pair appears twice over the real rows, and each
    (real i, ghost of j) pair has its mirror (j, ghost of i): every
    interacting pair appears exactly twice, so the global 1/2 is exact.
    """
    pos_ext, natoms = gm.pos_ext, gm.natoms
    r, next_, _ = pos_ext.shape
    dev = pos_ext.device
    row_block = row_block or default_row_block(r, natoms, next_,
                                               pos_ext.is_cuda)
    nblocks = -(-natoms // row_block)
    block = -(-natoms // nblocks)
    pad = nblocks * block - natoms
    rows = pos_ext[:, :natoms]
    ids = torch.arange(natoms, dtype=torch.int32, device=dev)
    if pad:
        rows = torch.cat([rows, rows.new_full((r, pad, 3), 1e30)], dim=1)
        ids = torch.cat([ids, ids.new_full((pad,), -1)])
    q = _q_matrix(pos_ext)
    sums = _row_sums_fn(pos_ext)
    e_tot = w_tot = 0.0
    for b in range(nblocks):
        blk = slice(b * block, (b + 1) * block)
        e, w = sums(pot, q, gm.parent_ext, rows[:, blk],
                    ids[blk].expand(r, -1), True)
        e_tot = e_tot + e.sum(-1)
        w_tot = w_tot + w.sum(-1)
    return 0.5 * e_tot, 0.5 * w_tot
