"""EAM energies over neighbour lists with a leading replica axis
(counterpart of ``neuralmelting_tpu.ops.eam_energy``).

Incremental-move scheme: the ensemble carries a per-atom density cache
rho (R, N). Moving atom i changes
    dE = sum_j [phi(r'_ij) - phi(r_ij)]            (pair part)
        + F(rho'_i) - F(rho_i)                      (own embedding)
        + sum_j [F(rho_j + drho_j) - F(rho_j)],     (neighbours' embedding)
with drho_j = rho(r'_ij) - rho(r_ij). Exactness for batched checkerboard
movers requires movers >= 2 rc apart (EAM's interaction range,
``models.eam.interaction_range``), so their neighbour sets within rc are
disjoint.

Moves carry dW = 0 (the incremental virial would need O(K^2) terms a
move): the pressure is refreshed by the full recompute at every record
(parallel/ensemble.py), as in the JAX package.

The potential is ``models.eam.EAMTables``; the functions take the JAX
functions' f32 operations in torch's summation order, and run on CPU and
CUDA tensors alike without a host copy, so a CUDA graph can capture them.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.models.eam import spline_eval_t, spline_vals_t
from neuralmelting_tpu_torch.ops.neighbors import NeighborList, _mi


def _gather_rows(v, idx):
    """v (R, N) or (R, N, C) gathered at the rows idx (R, ..., K)."""
    r = v.shape[0]
    flat = idx.reshape(r, -1)
    if v.dim() == 2:
        return v.gather(1, flat).reshape(idx.shape)
    c = v.shape[-1]
    return v.gather(1, flat[..., None].expand(-1, -1, c)).reshape(
        *idx.shape, c)


def _row_r(pot, pos, box, idx, count, centres):
    """Distances r and validity over neighbour rows, with the
    displacement components: idx (R, ..., K) rows, count (R, ...) their
    counts and centres (R, ..., 3), broadcasting over the middle axes.
    Returns r, valid, dx, dy, dz, each (R, ..., K); r is 1 where not
    valid."""
    r = pos.shape[0]
    lbox = box.reshape((r,) + (1,) * (idx.dim() - 1) + (3,))
    dx, dy, dz = _mi(centres[..., None, :] - _gather_rows(pos, idx),
                     lbox).unbind(-1)
    r2 = dx * dx + dy * dy + dz * dz
    slot = torch.arange(idx.shape[-1], device=idx.device)
    valid = (slot < count[..., None]) & (r2 < pot.rc * pot.rc)
    return torch.sqrt(torch.where(valid, r2, 1.0)), valid, dx, dy, dz


def rho_sums(pot, pos, box, nl: NeighborList):
    """Per-atom densities rho_i (R, N)."""
    r, valid, *_ = _row_r(pot, pos, box, nl.idx, nl.count, pos)
    (rho_val,) = spline_vals_t((pot.rho_coef,), pot.dr, r)
    return torch.where(valid, rho_val, 0.0).sum(-1)


def _pair_terms(pot, pos, box, nl: NeighborList):
    """The full-list terms shared by the energy, virial and forces."""
    r, valid, dx, dy, dz = _row_r(pot, pos, box, nl.idx, nl.count, pos)
    rho_val, rho_der = spline_eval_t(pot.rho_coef, pot.dr, r)
    rphi, rphi_der = spline_eval_t(pot.rphi_coef, pot.dr, r)
    phi = torch.where(valid, rphi / r, 0.0)
    rho_i = torch.where(valid, rho_val, 0.0).sum(-1)
    f_i, fp_i = spline_eval_t(pot.f_coef, pot.drho, rho_i)
    phi_der = torch.where(valid, (rphi_der - phi) / r, 0.0)
    fp_j = _gather_rows(fp_i, nl.idx)
    # (F'_i + F'_j) rho'(r), the embedding part of the pair derivative
    emb = torch.where(valid, (fp_i[..., None] + fp_j) * rho_der, 0.0)
    return r, valid, dx, dy, dz, phi, phi_der, f_i, emb


def total_energy_virial(pot, pos, box, nl: NeighborList):
    """(R,) pe and virial; densities recomputed from scratch."""
    r, valid, _, _, _, phi, phi_der, f_i, emb = _pair_terms(pot, pos, box,
                                                            nl)
    pe = f_i.sum(-1) + 0.5 * phi.sum((-2, -1))
    # w_ij = -r [phi'(r) + (F'_i + F'_j) rho'(r)]
    w = -r * (phi_der + emb)
    return pe, 0.5 * torch.where(valid, w, 0.0).sum((-2, -1))


def virial_scale(pot, pos, box, nl: NeighborList):
    """(R,) summed magnitudes 0.5 sum |w_ij| of the virial's pair terms:
    the scale of its f32 rounding. At low pressure the virial is a small
    difference of large terms, so two summation orders agree to this
    scale, not to the virial's own value."""
    r, valid, _, _, _, _, phi_der, _, emb = _pair_terms(pot, pos, box, nl)
    return 0.5 * torch.where(valid, r * (phi_der + emb), 0.0).abs().sum(
        (-2, -1))


def forces(pot, pos, box, nl: NeighborList):
    """(R, N, 3) forces; densities recomputed from scratch."""
    r, valid, dx, dy, dz, _, phi_der, _, emb = _pair_terms(pot, pos, box,
                                                           nl)
    # f_i = -sum_j [phi' + (F'_i + F'_j) rho'] (r_i - r_j) / r
    coef = torch.where(valid, -(phi_der + emb) / r, 0.0)
    return torch.stack([(coef * dx).sum(-1), (coef * dy).sum(-1),
                        (coef * dz).sum(-1)], dim=-1)


def delta_moves(pot, pos, box, nl: NeighborList, rho, ids, new_r):
    """Batched (dE, dW = 0, payload) for moving particles ``ids`` (R, M)
    to ``new_r`` (R, M, 3), movers >= 2 rc apart; ``rho`` the density
    cache (R, N). The old and new positions are evaluated as one (R, 2,
    M, K) block, and the four embedding terms as one evaluation (each
    element's value is the same). payload = (drho_rows (R, M, K),
    rho_i_new (R, M), rows (R, M, K), in_row (R, M, K)) for
    ``apply_accept``."""
    k, m = nl.capacity, ids.shape[1]
    rows = nl.idx.gather(1, ids[..., None].expand(-1, -1, k))
    cnt = nl.count.gather(1, ids)
    old = pos.gather(1, ids[..., None].expand(-1, -1, 3))
    r, valid, *_ = _row_r(pot, pos, box, rows[:, None], cnt[:, None],
                          torch.stack([old, new_r], dim=1))
    rho_val, rphi = spline_vals_t((pot.rho_coef, pot.rphi_coef), pot.dr, r)
    phi = torch.where(valid, rphi / r, 0.0)
    rho_c = torch.where(valid, rho_val, 0.0)
    de_pair = (phi[:, 1] - phi[:, 0]).sum(-1)
    drho_rows = rho_c[:, 1] - rho_c[:, 0]
    rho_i_new = rho_c[:, 1].sum(-1)
    rho_j = _gather_rows(rho, rows)
    # F at the mover's new and old density, then at its neighbours' new
    # and old densities
    (f,) = spline_vals_t((pot.f_coef,), pot.drho, torch.cat(
        [rho_i_new, rho.gather(1, ids), (rho_j + drho_rows).flatten(1),
         rho_j.flatten(1)], dim=1))
    f_new, f_old = f[:, :m], f[:, m:2 * m]
    fj_new, fj_old = f[:, 2 * m:].unflatten(1, (2, m, k)).unbind(1)
    in_row = torch.arange(k, device=rows.device) < cnt[..., None]
    de_emb_j = torch.where(in_row, fj_new - fj_old, 0.0).sum(-1)
    de = de_pair + (f_new - f_old) + de_emb_j
    return de, torch.zeros_like(de), (drho_rows, rho_i_new, rows, in_row)


def apply_accept(rho, ids, acc, payload):
    """The density cache after the accepted moves: each accepted row's
    drho added to its neighbours, then each accepted mover's own density
    set. Exact in any order: movers >= 2 rc apart change disjoint sets
    of densities (a neighbour in two movers' rows takes a nonzero drho
    from one of them at most), padding slots and refused movers add 0,
    and a refused mover (or the stand-in of an empty cell, which may
    repeat an accepted mover) writes nothing."""
    drho_rows, rho_i_new, rows, in_row = payload
    r = rho.shape[0]
    upd = torch.where(in_row & acc[..., None], drho_rows, 0.0)
    rho = rho.scatter_add(1, rows.reshape(r, -1), upd.reshape(r, -1))
    hit = torch.zeros_like(rho, dtype=torch.int32).scatter_add(
        1, ids, acc.to(torch.int32))
    new = torch.zeros_like(rho).scatter_add(
        1, ids, torch.where(acc, rho_i_new, 0.0))
    return torch.where(hit > 0, new, rho)
