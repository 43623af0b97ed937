"""The two EAM cell-MC kernels: B3 ``sweep`` and B4 ``total``.

Each function here is the counterpart of one Pallas TPU kernel of
``neuralmelting_tpu/ops/pallas/cellmc_eam.py`` and comes in two forms:

* a hand-written CUDA kernel for Hopper (``csrc/cellmc_eam_sweep.cu``,
  ``csrc/cellmc_eam_total.cu``), launched for CUDA tensors;
* a plain PyTorch version of the same function (``sweep_plain``,
  ``total_plain``), used for CPU tensors, by the tests, and by
  ``chip_smoke.py`` to check the kernels on the card.

The dispatch has no fallback: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches (plain calls are not counted).

Geometry: stride-3 colours (27 of them) and one mover per cell (J=1):
same-colour movers sit >= 2w >= 2rc apart, so their 27-cell
neighbourhoods are disjoint and the density-coupled acceptances of one
colour step are exact in parallel.

Layout (leading-R, the engine's): slabs x, y, z, rho are (R, C*K) f32,
count (R, C) int32, params (R, 8) f32 rows [beta, dpos, wx, wy, wz, Lx,
Ly, Lz], scale (R,) f32, seeds (ntiles, 2) int32, the stats (R, 8) f32.
``scal`` is the (8,) f32 [rc^2, u_lo, u_hi, q_lo, q_hi, rho_hi, 0, 0] and
``series`` the six coefficient tensors (c_phi, c_phid, c_rho, c_rhod,
c_f, c_fd) of ``eam_pack``. The JAX kernels take the slabs transposed.

The potential is the Chebyshev form (models/eam_cheb.py), evaluated by the
JAX kernels' Clenshaw recurrence, ``t = (2x - (a+b)) / (b-a)`` then
``b1' = 2t b1 - b2 + c[n-1-i]``, in the same operation order, so each
per-pair value is the JAX kernels' f32 value. Series are evaluated only
where their result is used (pairs inside the cutoff; neighbours whose
density changes). Sums over slots, offsets and cells are taken in torch's
order, so energies and densities agree with the JAX kernels to f32
rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from neuralmelting_tpu_torch.ops import rng
from neuralmelting_tpu_torch.ops.cellmc import _check, _route
from neuralmelting_tpu_torch.ops.cellmc_geom import (INVALID, CellGeom,
                                                     offsets26, stencil)

LAUNCHES = {"eam_sweep": 0, "eam_total": 0}

OFF27 = [(0, 0, 0)] + offsets26()        # own cell first
# pair terms per pass of the plain total (bounds its temporaries)
_PLAIN_MAX_ELEMS = 1 << 24
# longest series the kernels stage in shared memory
_MAX_SERIES = 64
# smem above this needs a GPU with more shared memory per block than Hopper
_MAX_SMEM = 232448


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def eam_pack(cheb, device):
    """Kernel transport of an EAMCheb: (scal (8,), series6, nser), f32
    tensors on ``device``; nser = (len c_phi, len c_rho, len c_f)."""
    f = np.float32
    scal = np.asarray([f(cheb.rc) * f(cheb.rc), cheb.u_lo, cheb.u_hi,
                       cheb.q_lo, np.sqrt(f(cheb.rho_hi)), cheb.rho_hi,
                       0.0, 0.0], np.float32)
    series = tuple(torch.tensor(np.asarray(getattr(cheb, n), np.float32),
                                device=device)
                   for n in ("c_phi", "c_phid", "c_rho", "c_rhod", "c_f",
                             "c_fd"))
    nser = (int(cheb.c_phi.shape[0]), int(cheb.c_rho.shape[0]),
            int(cheb.c_f.shape[0]))
    return torch.as_tensor(scal, device=device), series, nser


def _check_geom(geom: CellGeom):
    if geom.stride != 3 or geom.nsub != 1:
        raise ValueError("the EAM kernels take stride-3 colours with one "
                         f"mover per cell, got stride {geom.stride}, "
                         f"nsub {geom.nsub}")


def _check_series(series, dev):
    if len(series) != 6:
        raise ValueError(f"expected 6 series, got {len(series)}")
    for i, c in enumerate(series):
        _check(f"series[{i}]", c, (c.shape[0],), torch.float32, dev)
        if not 1 <= c.shape[0] <= _MAX_SERIES:
            raise ValueError(f"series[{i}] has {c.shape[0]} terms; the "
                             f"kernels take 1..{_MAX_SERIES}")
    for a in (0, 2, 4):
        if series[a].shape != series[a + 1].shape:
            raise ValueError("a series and its derivative differ in length")


# ---------------------------------------------------------------------------
# Clenshaw recurrence (the kernels' form)
# ---------------------------------------------------------------------------

def clenshaw(c, a, b, x):
    """Chebyshev series on [a, b] at x (clamped into [a, b]), in the JAX
    kernels' operation order. ``c`` is one series (n,), or several as rows
    (S, n) evaluated at x of shape (S, M): a series padded with leading
    zero top coefficients gives the same bits as the unpadded one."""
    xx = torch.minimum(torch.maximum(x, a), b)
    t = (2.0 * xx - (a + b)) / (b - a)
    t2 = 2.0 * t
    n = c.shape[-1]
    if c.dim() == 2:
        c = c[:, None, :]
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for i in range(n - 1):
        b1, b2 = t2 * b1 - b2 + c[..., n - 1 - i], b1
    return t * b1 - b2 + c[..., 0]


class _Pot:
    """The scalars and series of one call."""

    def __init__(self, scal, series):
        self.rc2, self.u_lo, self.u_hi = scal[0], scal[1], scal[2]
        self.q_lo, self.q_hi, self.rho_hi = scal[3], scal[4], scal[5]
        self.c = series

    def u_series(self, idx, u):
        """Series ``idx`` (indices into the six) at the 1-D u: (len(idx),
        M), one recurrence for all of them."""
        n = max(int(self.c[i].shape[0]) for i in idx)
        cs = torch.zeros((len(idx), n), dtype=torch.float32, device=u.device)
        for row, i in enumerate(idx):
            cs[row, :self.c[i].shape[0]] = self.c[i]
        return clenshaw(cs, self.u_lo, self.u_hi,
                        u[None].expand(len(idx), u.shape[0]))

    def femb(self, rho):
        """F(rho) through q = sqrt(rho), rho clamped to [0, rho_hi]."""
        q = torch.sqrt(torch.minimum(torch.clamp(rho, min=0.0), self.rho_hi))
        return clenshaw(self.c[4], self.q_lo, self.q_hi, q)

    def fembd(self, rho):
        """dF/drho = (dF/dq) / (2 q), rho clamped to [1e-12, rho_hi]."""
        q = torch.sqrt(torch.minimum(torch.clamp(rho, min=1e-12),
                                     self.rho_hi))
        return clenshaw(self.c[5], self.q_lo, self.q_hi, q) / (2.0 * q)


def _on(mask, values):
    """A zero tensor of ``mask``'s shape holding ``values`` at the mask's
    elements (values: (S, M) for S stacked results -> (S, *mask.shape))."""
    out = torch.zeros((values.shape[0],) + tuple(mask.shape),
                      dtype=torch.float32, device=mask.device)
    out[:, mask] = values
    return out


# ---------------------------------------------------------------------------
# B4: full EAM energy pass
# ---------------------------------------------------------------------------

def total(geom: CellGeom, slabs3, params, scal, series, scale,
          with_virial: bool):
    """Full EAM pass at isotropic scale ``scale`` (R,) of the slab
    coordinates. Returns (stats (R, 8) rows [E, W, E_pair, E_emb, 0,
    W_pair', W_emb', 0], rho (R, C*K) the densities of the scaled
    configuration, 0 in empty slots). W = -(W_pair' + W_emb') is the
    virial sum r f (the repo's sign); the W rows are 0 unless
    ``with_virial``. Replaces ``make_eam_total_fn`` of the JAX package;
    what bounds the CUDA kernel and how its design meets it: the note at
    the top of ``csrc/cellmc_eam_total.cu``."""
    _check_geom(geom)
    if _route(slabs3[0]) == "plain":
        return total_plain(geom, slabs3, params, scal, series, scale,
                           with_virial)
    return _total_cuda(geom, slabs3, params, scal, series, scale,
                       with_virial)


def _total_cuda(geom, slabs3, params, scal, series, scale, with_virial):
    from neuralmelting_tpu_torch.ops import _build
    x, y, z = slabs3
    r, dev = x.shape[0], x.device
    for nm, t in (("x", x), ("y", y), ("z", z)):
        _check(nm, t, (r, geom.rows), torch.float32, dev)
    _check("params", params, (r, 8), torch.float32, dev)
    _check("scal", scal, (8,), torch.float32, dev)
    _check("scale", scale, (r,), torch.float32, dev)
    _check_series(series, dev)
    lib = _build.load()
    smem = (lib.nm_eam_total_smem(geom.kcap)
            + lib.nm_eam_total_static_smem())
    if smem > _MAX_SMEM:
        raise ValueError(f"EAM total needs {smem} B of shared memory")
    stats = torch.empty((r, 8), dtype=torch.float32, device=dev)
    rho = torch.empty((r, geom.rows), dtype=torch.float32, device=dev)
    # the kernel's scratch: each cell's count and bounding box and, with
    # the virial, F'(rho) of every slot, read back by its second pass
    work = torch.empty((r, lib.nm_eam_total_work_words(
        *geom.ncell, geom.kcap, int(bool(with_virial)))),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nm_eam_total(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), params.data_ptr(),
            scal.data_ptr(), *(c.data_ptr() for c in series),
            scale.data_ptr(), stats.data_ptr(), rho.data_ptr(),
            work.data_ptr(), r, *geom.ncell, geom.kcap, series[0].shape[0],
            series[2].shape[0], series[4].shape[0], int(bool(with_virial)),
            stream)
    if err != 0:
        raise RuntimeError(f"EAM total kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["eam_total"] += 1
    return stats, rho


def total_plain(geom: CellGeom, slabs3, params, scal, series, scale,
                with_virial: bool):
    """Plain PyTorch B4, vectorized over (R, C, K movers, 27 offsets, K
    candidates) in replica chunks of at most _PLAIN_MAX_ELEMS terms."""
    x, y, z = slabs3
    r, dev = x.shape[0], x.device
    c, k = geom.ncells, geom.kcap
    pot = _Pot(scal, series)
    v = [a.reshape(r, c, k) for a in (x, y, z)]
    valid = v[0] < 0.1 * INVALID                               # (R, C, K)
    s2 = scale * scale
    lbox = params[:, 5:8]
    _, nb, img = stencil(geom, OFF27, dev)                     # (C, 27)
    kio = torch.arange(k, device=dev)
    selfm = kio[:, None] == kio[None, :]                       # (K, K)
    rch = max(1, _PLAIN_MAX_ELEMS // (c * k * 27 * k))
    chunks = [slice(r0, min(r, r0 + rch)) for r0 in range(0, r, rch)]

    def pairs(rs):
        """u = (r s)^2 (Rc, C, K, 27, K) and its in-cutoff pair mask."""
        cand = [(v[a][rs][:, nb, :]
                 + img[..., a].to(torch.float32)[None, :, :, None]
                 * lbox[rs, a, None, None, None])[:, :, None]
                for a in range(3)]                             # (Rc,C,1,27,K)
        mov = [v[a][rs][..., None, None] for a in range(3)]    # (Rc,C,K,1,1)
        d0 = cand[0] - mov[0]
        d1 = cand[1] - mov[1]
        d2 = cand[2] - mov[2]
        u = (d0 * d0 + d1 * d1 + d2 * d2) * s2[rs, None, None, None, None]
        ok = (cand[0] < 0.1 * INVALID) & valid[rs][..., None, None] & (
            u < pot.rc2)
        ok[:, :, :, 0] &= ~selfm                  # own cell: no self pair
        return u, ok

    rho = torch.zeros((r, c, k), dtype=torch.float32, device=dev)
    e_pair = torch.zeros(r, dtype=torch.float32, device=dev)
    w_pair = torch.zeros(r, dtype=torch.float32, device=dev)
    w_emb = torch.zeros(r, dtype=torch.float32, device=dev)
    for rs in chunks:
        u, ok = pairs(rs)
        # rows: f_rho, phi (and dphi/du for the virial)
        vals = _on(ok, pot.u_series((2, 0, 1) if with_virial else (2, 0),
                                    u[ok]))
        per_off = vals[0].sum(dim=-1)                          # (Rc,C,K,27)
        acc = per_off[..., 0]
        for o in range(1, 27):                     # offsets in JAX order
            acc = acc + per_off[..., o]
        rho[rs] = acc
        e_pair[rs] = 0.5 * vals[1].sum(dim=(1, 2, 3, 4))
        if with_virial:
            w_pair[rs] = 0.5 * torch.where(ok, 2.0 * u * vals[2], 0.0).sum(
                dim=(1, 2, 3, 4))
    e_emb = torch.where(valid, pot.femb(rho), 0.0).sum(dim=(1, 2))
    if with_virial:
        fp = torch.where(valid, pot.fembd(rho), 0.0)           # (R, C, K)
        for rs in chunks:
            u, ok = pairs(rs)
            rhod = _on(ok, pot.u_series((3,), u[ok]))[0]
            coef = fp[rs][..., None, None] + fp[rs][:, nb, :][:, :, None]
            w_emb[rs] = 0.5 * torch.where(ok, coef * 2.0 * u * rhod,
                                          0.0).sum(dim=(1, 2, 3, 4))
    stats = torch.zeros((r, 8), dtype=torch.float32, device=dev)
    stats[:, 0] = e_pair + e_emb
    stats[:, 1] = -(w_pair + w_emb)
    stats[:, 2] = e_pair
    stats[:, 3] = e_emb
    stats[:, 5] = w_pair
    stats[:, 6] = w_emb
    return stats, rho.reshape(r, c * k)


# ---------------------------------------------------------------------------
# B3: the position sweep
# ---------------------------------------------------------------------------

def sweep(geom: CellGeom, ncyc: int, rt: int, slabs4, count, params, scal,
          series, seeds):
    """One sweep of ncyc x 27 colour steps of cell-confined EAM position
    MC, one mover per cell. Updates x, y, z and the density slab rho IN
    PLACE (the JAX kernel aliases them in to out; rho must be exact on
    entry and is exact on exit, up to f32 accumulation) and returns stats
    (R, 8) f32 rows [pe_delta, n_accept, n_try, 0...]. ``rt`` is the JAX
    lane-tile width: the draws of replica r are keyed by ``seeds[r // rt]``
    at lane r % rt. Replaces ``make_eam_sweep_fn`` of the JAX package;
    what bounds the CUDA kernel and how its design meets it: the note at
    the top of ``csrc/cellmc_eam_sweep.cu``."""
    _check_geom(geom)
    if _route(slabs4[0]) == "plain":
        return sweep_plain(geom, ncyc, rt, slabs4, count, params, scal,
                           series, seeds)
    return _sweep_cuda(geom, ncyc, rt, slabs4, count, params, scal, series,
                       seeds)


def _sweep_cuda(geom, ncyc, rt, slabs4, count, params, scal, series, seeds):
    from neuralmelting_tpu_torch.ops import _build
    x, y, z, rho = slabs4
    r, dev = x.shape[0], x.device
    ntiles = -(-r // rt)
    for nm, t in (("x", x), ("y", y), ("z", z), ("rho", rho)):
        _check(nm, t, (r, geom.rows), torch.float32, dev)
    _check("count", count, (r, geom.ncells), torch.int32, dev)
    _check("params", params, (r, 8), torch.float32, dev)
    _check("scal", scal, (8,), torch.float32, dev)
    _check("seeds", seeds, (ntiles, 2), torch.int32, dev)
    _check_series(series, dev)
    lib = _build.load()
    smem = (lib.nm_eam_sweep_smem(*geom.ncell, geom.kcap)
            + lib.nm_eam_sweep_static_smem())
    if smem > _MAX_SMEM:
        raise ValueError(f"EAM sweep needs {smem} B of shared memory")
    stats = torch.empty((r, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nm_eam_sweep(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), rho.data_ptr(),
            count.data_ptr(), params.data_ptr(), scal.data_ptr(),
            series[0].data_ptr(), series[2].data_ptr(), series[4].data_ptr(),
            seeds.data_ptr(), stats.data_ptr(), r, *geom.ncell, geom.kcap,
            series[0].shape[0], series[2].shape[0], series[4].shape[0],
            ncyc, rt, stream)
    if err != 0:
        raise RuntimeError(f"EAM sweep kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["eam_sweep"] += 1
    return stats


def sweep_plain(geom: CellGeom, ncyc: int, rt: int, slabs4, count, params,
                scal, series, seeds):
    """Plain PyTorch B3, vectorized over replicas and the cw movers of the
    active colour, each against its 27-cell stencil: (R, cw, 27, K)."""
    x, y, z, rho = slabs4
    r, dev = x.shape[0], x.device
    c, k, cw = geom.ncells, geom.kcap, geom.cw
    v = [a.view(r, c, k) for a in (x, y, z, rho)]
    cfull, nb, img = stencil(geom, OFF27, dev)
    pot = _Pot(scal, series)
    beta = params[:, 0, None]                                # (R, 1)
    dpos = params[:, 1, None]
    wvec = [params[:, 2 + a, None] for a in range(3)]
    lvec = [params[:, 5 + a, None, None, None] for a in range(3)]
    ridx = torch.arange(r, device=dev)
    tile, lane = ridx // rt, ridx % rt
    k0 = seeds[tile, 0][None, :, None]
    k1 = seeds[tile, 1][None, :, None]
    flat = (torch.arange(cw, device=dev)[None, :] * rt
            + lane[:, None])[None]                           # (1, R, cw)
    kio = torch.arange(k, device=dev)
    st = [torch.zeros(r, dtype=torch.float32, device=dev) for _ in range(3)]
    nsteps = ncyc * geom.ncolors
    # five uniforms per mover and colour step at counters step*8 + 0..4:
    # pick, dx, dy, dz, accept; the whole sweep's at once
    ctr = (torch.arange(nsteps, device=dev)[:, None] * 8
           + torch.arange(5, device=dev)[None, :])[..., None, None]
    bits, _ = rng.threefry2x32(k0[None], k1[None], ctr, flat[None])
    draws = rng.bits_to_u01(bits)                        # (steps,5,R,cw)

    for step in range(nsteps):
        color = step % geom.ncolors
        cells = slice(color * cw, (color + 1) * cw)
        nbc, imc = nb[cells], img[cells]                     # (cw, 27)
        u_pick, u_dx, u_dy, u_dz, u_acc = draws[step]        # (R, cw)
        cnt = count[:, cells]
        valid = cnt > 0
        pick = torch.minimum((u_pick * cnt.to(torch.float32)).to(torch.int32),
                             torch.clamp(cnt - 1, min=0)).to(torch.int64)
        disp = [dpos * (2.0 * u - 1.0) for u in (u_dx, u_dy, u_dz)]

        own = [a[:, cells, :].clone() for a in v]            # (R, cw, K)
        m = [torch.gather(b, 2, pick[..., None])[..., 0] for b in own]
        mn = [m[a] + disp[a] for a in range(3)]
        cand = [v[a][:, nbc, :] + imc[..., a].to(torch.float32)[
            None, :, :, None] * lvec[a] for a in range(3)]   # (R,cw,27,K)
        rho_c = v[3][:, nbc, :]
        onehot = kio == pick[..., None]                      # (R, cw, K)
        candv = cand[0] < 0.1 * INVALID
        candv[:, :, 0] &= ~onehot                  # not the mover itself

        def u_of(p):
            d0 = cand[0] - p[0][..., None, None]
            d1 = cand[1] - p[1][..., None, None]
            d2 = cand[2] - p[2][..., None, None]
            return d0 * d0 + d1 * d1 + d2 * d2

        uo, un = u_of(m), u_of(mn)
        mo = candv & (uo < pot.rc2)
        mnw = candv & (un < pot.rc2)
        # f_rho and phi at the old and the new pairs, one recurrence
        no = int(mo.sum())
        f_u = pot.u_series((2, 0), torch.cat([uo[mo], un[mnw]]))
        fo, po = _on(mo, f_u[:, :no])
        fn, pn = _on(mnw, f_u[:, no:])
        drho = fn - fo                                       # (R,cw,27,K)
        de_pair = (pn - po).sum(dim=(2, 3))
        drho_m = drho.sum(dim=(2, 3))
        # F at rho_j + drho_j and rho_j of every neighbour whose density
        # changes (elsewhere the difference is exactly 0), and at the
        # mover's new and old density, one recurrence
        moved = drho != 0
        rr, dd = rho_c[moved], drho[moved]
        nm_ = rr.shape[0]
        f_r = pot.femb(torch.cat([rr + dd, rr, (m[3] + drho_m).reshape(-1),
                                  m[3].reshape(-1)]))
        demb = torch.zeros_like(drho)
        demb[moved] = f_r[:nm_] - f_r[nm_:2 * nm_]
        de_emb = demb.sum(dim=(2, 3))
        f_mm = f_r[2 * nm_:].reshape(2, r, cw)
        de = de_pair + de_emb + f_mm[0] - f_mm[1]            # (R, cw)

        incell = valid
        for a in range(3):
            lo = cfull[cells, a].to(torch.float32)[None, :] * wvec[a]
            incell = incell & (mn[a] >= lo) & (mn[a] < lo + wvec[a])
        acc = valid & incell & (torch.log(u_acc) < -beta * de)

        # apply: positions, the own cell's densities, then the 26
        # neighbour cells' (distinct cells: the writes do not overlap)
        acc3 = acc[..., None]
        upd = onehot & acc3
        for a in range(3):
            v[a][:, cells, :] = own[a] + torch.where(upd, disp[a][..., None],
                                                     0.0)
        own_d = torch.where(acc3, drho[:, :, 0], 0.0) + torch.where(
            upd, drho_m[..., None], 0.0)
        v[3][:, cells, :] = own[3] + own_d
        idx = nbc[:, 1:].reshape(-1)
        dr = torch.where(acc[..., None, None], drho[:, :, 1:], 0.0)
        v[3][:, idx, :] = v[3][:, idx, :] + dr.reshape(r, -1, k)

        st[0] = st[0] + torch.where(acc, de, 0.0).sum(dim=1)
        st[1] = st[1] + acc.to(torch.float32).sum(dim=1)
        st[2] = st[2] + valid.to(torch.float32).sum(dim=1)

    out = torch.zeros((r, 8), dtype=torch.float32, device=dev)
    for i in range(3):
        out[:, i] = st[i]
    return out
