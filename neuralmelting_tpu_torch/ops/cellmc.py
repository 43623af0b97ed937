"""The two cell-MC kernels: B2 ``sweep`` and B1 ``total``.

Each function here is the counterpart of one Pallas TPU kernel of
``neuralmelting_tpu/ops/pallas/cellmc.py`` and comes in two forms:

* a hand-written CUDA kernel for Hopper (``csrc/cellmc_sweep.cu``,
  ``csrc/cellmc_total.cu``), launched for CUDA tensors;
* a plain PyTorch version of the same function (``sweep_plain``,
  ``total_plain``), used for CPU tensors, by the tests, and by
  ``chip_smoke.py`` to check the kernels on the card.

The dispatch has no fallback: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches (plain calls are not counted), so a run can show that its main
path went through the kernels.

Layout (leading-R, the engine's): slabs x, y, z are (R, C*K) f32, count
(R, C) int32, params (R, 8) f32 rows [beta, dpos, wx, wy, wz, Lx, Ly, Lz],
pot3 (4,) f32 [eps, sigma, rc, 0], scale (R,) f32, seeds (ntiles, 2)
int32, and the outputs (R, 8) f32. The JAX kernels take the transpose.

The plain versions compute each pair term with the JAX kernels' f32
arithmetic and follow their summation structure (offsets [(0,0,0)] + the
26 others, a sum over K per offset added in offset order, then the
sequential resolve), so they can be held against the JAX kernels decision
by decision; sums over K, over cells and over a mover's corrections are
taken in torch's order, so energies agree to f32 rounding, not bit for
bit.
"""

from __future__ import annotations

import torch

from neuralmelting_tpu_torch.ops import rng
from neuralmelting_tpu_torch.ops.cellmc_geom import (INVALID, CellGeom,
                                                     offsets13, offsets26,
                                                     stencil)

LAUNCHES = {"sweep": 0, "total": 0}

# smem above this needs a GPU with more shared memory per block than Hopper
_MAX_SMEM = 232448
# pair terms per pass of a plain version (bounds its temporaries)
_PLAIN_MAX_ELEMS = 1 << 24


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def combine_sums(sums, eps, scale):
    """(E, W, E_scaled) per replica from ``total``'s raw pair sums."""
    s12o, s6o, s12s, s6s = sums[:, 0], sums[:, 1], sums[:, 2], sums[:, 3]
    e = eps * (s12o - s6o)
    w = eps * (12.0 * s12o - 6.0 * s6o)
    si = 1.0 / scale
    si6 = si * si * si * si * si * si
    e_scaled = eps * (si6 * si6 * s12s - si6 * s6s)
    return e, w, e_scaled


def _check(name, t, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(t) -> str:
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no cell-MC kernel for device {t.device}")


def _check_geom(geom: CellGeom):
    if geom.stride != 2:
        raise ValueError("the cell-MC kernels take the stride-2 (pair "
                         f"potential) checkerboard, got stride {geom.stride}")


# ---------------------------------------------------------------------------
# B1: total pair sums
# ---------------------------------------------------------------------------

def total(geom: CellGeom, slabs, params, pot3, scale):
    """Raw LJ pair sums per replica, (R, 8) f32 rows [S12o, S6o, S12s,
    S6s, 0...], every unordered pair once:

      S12o = sum_{r<rc}   4 (sigma/r)^12    S6o = sum_{r<rc}   4 (sigma/r)^6
      S12s = sum_{r<rc/s} 4 (sigma/r)^12    S6s = sum_{r<rc/s} 4 (sigma/r)^6

    ``combine_sums`` gives E, the pair virial W and the exact energy
    E(s x) of the configuration scaled by ``scale`` (LJ scales
    homogeneously). Replaces ``make_total_fn`` of the JAX package; what
    bounds the CUDA kernel and how its design meets it: the note at the
    top of ``csrc/cellmc_total.cu``. K must be a multiple of 8, as the JAX
    kernel asserts (``make_geom`` and ``tight_kcap`` guarantee it).
    """
    _check_geom(geom)
    if geom.kcap % 8:
        raise ValueError(f"kcap={geom.kcap} must be a multiple of 8")
    if _route(slabs[0]) == "plain":
        return total_plain(geom, slabs, params, pot3, scale)
    return _total_cuda(geom, slabs, params, pot3, scale)


def _total_cuda(geom, slabs, params, pot3, scale):
    from neuralmelting_tpu_torch.ops import _build
    x, y, z = slabs
    r, dev = x.shape[0], x.device
    for nm, t in (("x", x), ("y", y), ("z", z)):
        _check(nm, t, (r, geom.rows), torch.float32, dev)
    _check("params", params, (r, 8), torch.float32, dev)
    _check("pot3", pot3, (4,), torch.float32, dev)
    _check("scale", scale, (r,), torch.float32, dev)
    if 3 * geom.rows * 4 > _MAX_SMEM:
        raise ValueError(f"slab of {geom.rows} rows exceeds shared memory")
    out = torch.empty((r, 8), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nm_cellmc_total(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), params.data_ptr(),
            pot3.data_ptr(), scale.data_ptr(), out.data_ptr(), r,
            *geom.ncell, geom.kcap, stream)
    if err != 0:
        raise RuntimeError(f"cellmc total kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["total"] += 1
    return out


def total_plain(geom: CellGeom, slabs, params, pot3, scale):
    """Plain PyTorch B1: own cell at weight 1/2 with the self pair masked,
    plus the 13 half-stencil offsets, vectorized over (R, C, K, K) in
    replica chunks of at most _PLAIN_MAX_ELEMS pair terms."""
    x, y, z = slabs
    r, dev = x.shape[0], x.device
    c, k = geom.ncells, geom.kcap
    offs = [(0, 0, 0)] + offsets13()
    _, nb, img = stencil(geom, offs, dev)
    sig2 = pot3[1] * pot3[1]
    rc2 = pot3[2] * pot3[2]
    rc2s = rc2 / (scale * scale)                          # (R,)
    lbox = params[:, 5:8]
    v = [a.reshape(r, c, k) for a in (x, y, z)]
    selfm = torch.eye(k, dtype=torch.bool, device=dev)
    out = torch.zeros((r, 8), dtype=torch.float32, device=dev)
    rch = max(1, _PLAIN_MAX_ELEMS // (c * k * k))
    for r0 in range(0, r, rch):
        rs = slice(r0, min(r, r0 + rch))
        mov = [a[rs][:, :, :, None] for a in v]           # (Rc, C, K, 1)
        lb = lbox[rs]
        rcs = rc2s[rs][:, None, None, None]
        for o in range(len(offs)):
            cand = [(a[rs][:, nb[:, o], :]
                     + img[:, o, ax].to(torch.float32)[None, :, None]
                     * lb[:, ax, None, None])[:, :, None, :]
                    for ax, a in enumerate(v)]            # (Rc, C, 1, K)
            d0 = cand[0] - mov[0]
            d1 = cand[1] - mov[1]
            d2 = cand[2] - mov[2]
            r2 = d0 * d0 + d1 * d1 + d2 * d2
            ok = (cand[0] < 0.1 * INVALID) & (mov[0] < 0.1 * INVALID)
            if o == 0:
                ok = ok & ~selfm
            sr2 = sig2 / torch.clamp(r2, min=1e-12)
            sr6 = sr2 * sr2 * sr2
            q6 = 4.0 * sr6
            q12 = q6 * sr6
            mo = ok & (r2 < rc2)
            ms = ok & (r2 < rcs)
            weight = 0.5 if o == 0 else 1.0
            for row, (mask, q) in enumerate(((mo, q12), (mo, q6),
                                             (ms, q12), (ms, q6))):
                out[rs, row] += weight * torch.where(mask, q, 0.0).sum(
                    dim=(1, 2, 3))
    return out


# ---------------------------------------------------------------------------
# B2: the position sweep
# ---------------------------------------------------------------------------

def sweep(geom: CellGeom, ncyc: int, rt: int, slabs, count, params, pot3,
          seeds):
    """One sweep of ncyc x 8 colour steps of cell-confined checkerboard
    position MC. Updates the slabs IN PLACE (the JAX kernel aliases them
    in to out) and returns stats (R, 8) f32 rows [pe_delta, n_accept,
    n_try, 0...]. ``rt`` is the JAX lane-tile width (``pick_rt``): the
    draws of replica r are keyed by ``seeds[r // rt]`` at lane r % rt.
    Replaces ``make_sweep_fn`` of the JAX package; what bounds the CUDA
    kernel and how its design meets it: the note at the top of
    ``csrc/cellmc_sweep.cu``."""
    _check_geom(geom)
    if _route(slabs[0]) == "plain":
        return sweep_plain(geom, ncyc, rt, slabs, count, params, pot3, seeds)
    return _sweep_cuda(geom, ncyc, rt, slabs, count, params, pot3, seeds)


def _sweep_cuda(geom, ncyc, rt, slabs, count, params, pot3, seeds):
    from neuralmelting_tpu_torch.ops import _build
    x, y, z = slabs
    r, dev = x.shape[0], x.device
    ntiles = -(-r // rt)
    for nm, t in (("x", x), ("y", y), ("z", z)):
        _check(nm, t, (r, geom.rows), torch.float32, dev)
    _check("count", count, (r, geom.ncells), torch.int32, dev)
    _check("params", params, (r, 8), torch.float32, dev)
    _check("pot3", pot3, (4,), torch.float32, dev)
    _check("seeds", seeds, (ntiles, 2), torch.int32, dev)
    if not 1 <= geom.nsub <= 32:
        raise ValueError(f"sweep kernel takes 1..32 movers per cell, got "
                         f"nsub={geom.nsub}")
    lib = _build.load()
    smem = lib.nm_cellmc_sweep_smem(*geom.ncell, geom.kcap)
    if smem > _MAX_SMEM:
        raise ValueError(f"sweep needs {smem} B of shared memory")
    stats = torch.empty((r, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nm_cellmc_sweep(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), count.data_ptr(),
            params.data_ptr(), pot3.data_ptr(), seeds.data_ptr(),
            stats.data_ptr(), r, *geom.ncell, geom.kcap, geom.nsub, ncyc,
            rt, stream)
    if err != 0:
        raise RuntimeError(f"cellmc sweep kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["sweep"] += 1
    return stats


def _eterm4(r2, sig2, rc2):
    """4 ((sigma/r)^12 - (sigma/r)^6), zero beyond rc."""
    sr2 = sig2 / r2
    sr6 = sr2 * sr2 * sr2
    return 4.0 * torch.where(r2 < rc2, sr6 * sr6 - sr6, 0.0)


def _ediff(r2n, r2o, sig2, rc2):
    """eterm(r2n) - eterm(r2o) with one shared divide, q = sig2/(r2n r2o).
    Empty slots (r2 = inf) fail the cutoff; the mover's own old slot
    (r2o = 0, NaN here) is masked by the caller."""
    q = sig2 / (r2n * r2o)
    s2n = q * r2o
    s2o = q * r2n
    s6n = s2n * s2n * s2n
    s6o = s2o * s2o * s2o
    en = torch.where(r2n < rc2, s6n * s6n - s6n, 0.0)
    eo = torch.where(r2o < rc2, s6o * s6o - s6o, 0.0)
    return en - eo


def sweep_plain(geom: CellGeom, ncyc: int, rt: int, slabs, count, params,
                pot3, seeds, trace=None):
    """Plain PyTorch B2, vectorized over replicas, movers and cells of the
    active colour; mover arrays are (R, J, cw). The candidate field is
    evaluated for as many offsets at once as _PLAIN_MAX_ELEMS allows.

    ``trace``: a list to append, per colour step, the movers' slots and
    Metropolis inputs (pick, valid, incell, ln_u, threshold
    -beta eps dE, accepted), for diagnosing a flipped near-tie."""
    x, y, z = slabs
    r, dev = x.shape[0], x.device
    c, k, cw, j = geom.ncells, geom.kcap, geom.cw, geom.nsub
    v = [a.view(r, c, k) for a in (x, y, z)]
    cfull, nb, img = stencil(geom, [(0, 0, 0)] + offsets26(), dev)
    eps = pot3[0]
    sig2 = pot3[1] * pot3[1]
    rc2 = pot3[2] * pot3[2]
    beta = params[:, 0, None]                                # (R, 1)
    dpos = params[:, 1, None, None]                          # (R, 1, 1)
    wvec = [params[:, 2 + a, None] for a in range(3)]        # (R, 1)
    lvec = [params[:, 5 + a, None, None] for a in range(3)]  # (R, 1, 1)
    ridx = torch.arange(r, device=dev)
    tile, lane = ridx // rt, ridx % rt
    k0 = seeds[tile, 0][:, None, None]
    k1 = seeds[tile, 1][:, None, None]
    aio = torch.arange(j, device=dev)[None, :, None]         # (1, J, 1)
    cio = torch.arange(cw, device=dev)[None, None, :]
    flat = (aio * cw + cio) * rt + lane[:, None, None]       # (R, J, cw)
    kio = torch.arange(k, device=dev)
    st = [torch.zeros(r, dtype=torch.float32, device=dev) for _ in range(3)]

    # offsets per pass over the candidate field, bounding its memory
    og = max(1, min(27, _PLAIN_MAX_ELEMS // max(r * j * cw * k, 1)))

    for step in range(ncyc * geom.ncolors):
        color = step % geom.ncolors
        cells = slice(color * cw, (color + 1) * cw)
        cnt = count[:, cells]                                # (R, cw)
        ctr = (step * 8 + torch.arange(2, device=dev))[:, None, None, None]
        (a0, b0), (a1, b1) = rng.threefry2x32(k0, k1, ctr, flat)
        u_acc = rng.bits_to_u01(a0)
        u0 = rng.bits_to_u01(a1)[:, 0]                       # (R, cw)
        disp = [dpos * rng.sym16(b0, 0), dpos * rng.sym16(b0, 16),
                dpos * rng.sym16(b1, 0)]
        # J consecutive slots from a random start s0, wrapping at cnt
        s0 = torch.minimum((u0 * cnt.to(torch.float32)).to(torch.int32),
                           torch.clamp(cnt - 1, min=0))
        cnt_t = cnt[:, None, :]
        raw = s0[:, None, :] + aio
        pick = torch.where(raw >= cnt_t, raw - cnt_t, raw).to(torch.int64)
        valid = aio < cnt_t                                  # (R, J, cw)

        own = [a[:, cells, :] for a in v]                    # (R, cw, K)
        m = [torch.gather(b[:, None].expand(r, j, cw, k), 3,
                          pick[..., None])[..., 0] for b in own]
        mn = [m[a] + disp[a] for a in range(3)]

        # dE against the own cell (offset 0) and the 26 neighbours at the
        # colour-step-start positions: per offset a sum over K, added in
        # offset order
        de = torch.zeros((r, j, cw), dtype=torch.float32, device=dev)
        onehot = kio[None, None, None, :] == pick[..., None]  # (R,J,cw,K)
        for o0 in range(0, 27, og):
            offs = slice(o0, min(27, o0 + og))
            c5 = [(v[a][:, nb[cells, offs], :]
                   + img[cells, offs, a].to(torch.float32)[None, :, :, None]
                   * lvec[a][..., None])[:, None] for a in range(3)]

            def r2of(p):
                d0 = c5[0] - p[0][..., None, None]
                d1 = c5[1] - p[1][..., None, None]
                d2 = c5[2] - p[2][..., None, None]
                return d0 * d0 + d1 * d1 + d2 * d2           # (R,J,cw,O,K)

            diff = _ediff(r2of(mn), r2of(m), sig2, rc2)
            if o0 == 0:
                # the mover's own old slot: r2_old = 0 -> NaN, masked
                diff[..., 0, :] = torch.where(onehot, 0.0, diff[..., 0, :])
            part = diff.sum(dim=-1)                          # (R,J,cw,O)
            for o in range(part.shape[-1]):
                de = de + 4.0 * part[..., o]

        # confinement: the trial stays in its cell on every axis
        incell = valid
        for a in range(3):
            lo = cfull[cells, a].to(torch.float32)[None, :] * wvec[a]
            incell = incell & (mn[a] >= lo[:, None]) & (
                mn[a] < (lo + wvec[a])[:, None])
        ln_u = torch.log(u_acc)

        # exact pair corrections between movers ai and bi (all pairs)
        def pe(p, q):
            d0 = p[0][:, :, None] - q[0][:, None, :]
            d1 = p[1][:, :, None] - q[1][:, None, :]
            d2 = p[2][:, :, None] - q[2][:, None, :]
            return _eterm4(d0 * d0 + d1 * d1 + d2 * d2, sig2, rc2)

        corr = pe(mn, mn) - pe(mn, m) - pe(m, mn) + pe(m, m)  # (R,J,J,cw)

        # sequential resolve in scan order
        accf = torch.zeros((r, j, cw), dtype=torch.float32, device=dev)
        thr = torch.zeros((r, j, cw), dtype=torch.float32, device=dev)
        de_acc = torch.zeros(r, dtype=torch.float32, device=dev)
        for ai in range(j):
            # corrections for the earlier movers that were accepted
            dej = de[:, ai] + torch.sum(accf[:, :ai] * corr[:, ai, :ai], dim=1)
            thr[:, ai] = -beta * eps * dej
            acc = incell[:, ai] & (ln_u[:, ai] < thr[:, ai])
            accf[:, ai] = acc.to(torch.float32)
            de_acc = de_acc + torch.where(acc, eps * dej, 0.0).sum(dim=1)
        nacc = accf.sum(dim=(1, 2))

        # apply the accepted displacements
        accj = accf > 0                                      # (R, J, cw)
        if trace is not None:
            trace.append(dict(step=step, color=color, pick=pick,
                              valid=valid, incell=incell, ln_u=ln_u,
                              thr=thr, acc=accj))
        idx = pick.transpose(1, 2)                           # (R, cw, J)
        for a in range(3):
            upd = torch.zeros((r, cw, k), dtype=torch.float32, device=dev)
            upd.scatter_add_(2, idx, torch.where(accj, disp[a], 0.0)
                             .transpose(1, 2))
            v[a][:, cells, :] = own[a] + upd

        st[0] = st[0] + de_acc
        st[1] = st[1] + nacc
        st[2] = st[2] + valid.to(torch.float32).sum(dim=(1, 2))

    out = torch.zeros((r, 8), dtype=torch.float32, device=dev)
    for i in range(3):
        out[:, i] = st[i]
    return out
