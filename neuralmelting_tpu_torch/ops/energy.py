"""Total and incremental LJ pair energies, brute force O(N^2), plain torch.

Counterpart of ``neuralmelting_tpu.ops.energy``: the serial engine's
energy backend (``sampler/moves.py::brute_backend``) and the oracle of the
brute-force kernel B5 (``ops/lj_delta.py``). One configuration, pos (N, 3)
and box (3,); minimum image on every displacement (exact for rc <
min(box)/2). ``virial`` is the scalar pair virial W = sum_pairs r f; the
pressure is P = (N kb T + W/3) / V.

Each pair term has the JAX functions' f32 operations; sums are taken in
torch's order, so totals agree with JAX to f32 rounding.
"""

from __future__ import annotations

import torch


def min_image(disp, box):
    """Minimum-image displacement for an orthorhombic box (3,); rounds half
    to even, as ``jnp.round``."""
    return disp - box * torch.round(disp / box)


def _r2(d):
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def pair_energy_virial(pot, pos, box):
    """Total pair energy and virial over all pairs: (pe, virial) 0-dim."""
    n = pos.shape[0]
    _, rc2, _, _ = pot.f32_consts()
    r2 = _r2(min_image(pos[None, :, :] - pos[:, None, :], box))
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = (r2 < rc2) & ~eye
    e, w = pot.pair_e_w(torch.where(mask, r2, 1.0))
    return (0.5 * torch.where(mask, e, 0.0).sum(),
            0.5 * torch.where(mask, w, 0.0).sum())


def forces(pot, pos, box):
    """Pair forces (N, 3): f_i = sum_j (w(r) / r^2) (r_i - r_j)."""
    n = pos.shape[0]
    _, rc2, _, _ = pot.f32_consts()
    disp = min_image(pos[:, None, :] - pos[None, :, :], box)
    r2 = _r2(disp)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = (r2 < rc2) & ~eye
    r2s = torch.where(mask, r2, 1.0)
    _, w = pot.pair_e_w(r2s)
    coef = torch.where(mask, w / r2s, 0.0)
    return (coef[:, :, None] * disp).sum(dim=1)


def delta_move_brute(pot, pos, box, i, new_ri):
    """(dE, dW) for moving atom ``i`` (an int or a 0-dim integer tensor) to
    ``new_ri``: the 2N pair terms that involve it, O(N)."""
    n = pos.shape[0]
    _, rc2, _, _ = pot.f32_consts()
    notself = torch.arange(n, device=pos.device) != i

    def side(ri):
        r2 = _r2(min_image(pos - ri, box))
        mask = (r2 < rc2) & notself
        e, w = pot.pair_e_w(torch.where(mask, r2, 1.0))
        return (torch.where(mask, e, 0.0).sum(),
                torch.where(mask, w, 0.0).sum())

    e_old, w_old = side(pos[i])
    e_new, w_new = side(new_ri)
    return e_new - e_old, w_new - w_old
