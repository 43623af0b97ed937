"""Inputs shared by the port's EAM parity tests (test_torch_eam_*.py);
this module holds no tests.

The rc=3.8 synthetic Al table, its Chebyshev refit computed by the JAX
package and carried into the port with ``cheb_from_numpy`` (both sides
then evaluate identical series), and jittered 4x4x4 fcc Al replicas (256
atoms) binned at the stride-3 geometry: a (3, 3, 3) cell grid, one cell
per colour, K=16 (the smallest multiple of 8 above the largest cell
count, 14). ``brute`` is an independent reference: the O(N^2)
minimum-image EAM energy and densities of the same series in float64.
"""

import os

import numpy as np
import torch
from numpy.polynomial import chebyshev as NC

import jax.numpy as jnp

from neuralmelting_tpu.models import eam as JE
from neuralmelting_tpu.models import eam_cheb as JEC
from neuralmelting_tpu.models import eam_gen as JG
from neuralmelting_tpu.ops.pallas import cellmc as CM
from neuralmelting_tpu_torch.models import eam_cheb as TEC
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG

KB = 8.617333262e-5
SHIFT = (0.3, 0.65, 0.11)
FIELDS = ("rc", "u_lo", "u_hi", "rho_hi", "q_lo", "c_phi", "c_phid",
          "c_rho", "c_rhod", "c_f", "c_fd")


def write_table(directory) -> str:
    path = os.path.join(str(directory), "al38.eam.alloy")
    JG.write_setfl(path, rc=3.8)
    return path


def chebs(path):
    """(JAX EAMCheb, the port's EAMCheb carrying the same series)."""
    jc = JEC.from_spline(JE.load(path))
    arrays = {f: np.asarray(getattr(jc, f)) for f in FIELDS}
    arrays.update(rc_host=jc.rc_host, fit_err=jc.fit_err)
    return jc, TEC.cheb_from_numpy(arrays)


def case(cheb, temps, seed, kcap=16, dpos=0.15):
    """R = len(temps) replicas, each its own jittered lattice."""
    r = len(temps)
    pos0, box = make_supercell("fcc", 4.05, (4, 4, 4))
    box = np.asarray(box, np.float32)
    g = np.random.default_rng(seed)
    pos = np.stack([(pos0 + 0.08 * g.standard_normal(pos0.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    boxes = np.repeat(box[None], r, 0)
    geom = CG.make_geom(box, cheb.rc_host, pos.shape[1], nsub=1, stride=3,
                        kcap=kcap)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.tensor(SHIFT))
    assert not bool(over) and geom.ncell == (3, 3, 3)
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = np.concatenate(
        [(1.0 / (KB * np.asarray(temps, np.float32)))[:, None],
         np.full((r, 1), dpos, np.float32), w, boxes], 1).astype(np.float32)
    scal, series, nser = CE.eam_pack(cheb, "cpu")
    return dict(pos=pos, box=box, boxes=boxes, geom=geom, slabs=(x, y, z),
                ids=ids, count=count, params=torch.as_tensor(params),
                scal=scal, series=series, nser=nser, r=r)


def jax_geom(c):
    return CM.make_geom(c["box"], 3.8, 256, nsub=1, stride=3,
                        kcap=c["geom"].kcap)


def jt(a):
    """A leading-R port tensor as the JAX kernels' (rows, R) array."""
    return jnp.asarray(np.ascontiguousarray(a.numpy().T))


def _cheb(c, a, b, x):
    x = np.clip(x, float(a), float(b))
    return NC.chebval((2.0 * x - (float(a) + float(b))) / (float(b)
                                                          - float(a)),
                      np.asarray(c, np.float64))


def brute(cheb, pos, box, scale=1.0):
    """(E, rho per atom) of positions (N, 3) in box (3,), both scaled by
    ``scale``, from the same Chebyshev series, in float64."""
    p = np.asarray(pos, np.float64) * scale
    bx = np.asarray(box, np.float64) * scale
    d = p[:, None, :] - p[None, :, :]
    d -= bx * np.round(d / bx)
    u = (d * d).sum(-1)
    n = p.shape[0]
    rc2 = float(np.float32(cheb.rc) * np.float32(cheb.rc))
    mask = (u < rc2) & ~np.eye(n, dtype=bool)
    phi = np.where(mask, _cheb(cheb.c_phi, cheb.u_lo, cheb.u_hi, u), 0.0)
    rho = np.where(mask, _cheb(cheb.c_rho, cheb.u_lo, cheb.u_hi, u),
                   0.0).sum(-1)
    q = np.sqrt(np.clip(rho, 0.0, float(cheb.rho_hi)))
    f = _cheb(cheb.c_f, cheb.q_lo, np.sqrt(np.float32(cheb.rho_hi)), q)
    return 0.5 * phi.sum() + f.sum(), rho
