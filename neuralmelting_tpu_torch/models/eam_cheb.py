"""Chebyshev-series EAM: the potential the EAM cell-MC kernels sample (the
port's counterpart of ``neuralmelting_tpu.models.eam_cheb``).

The three EAM functions of a setfl table are refit as global Chebyshev
series evaluated by Clenshaw recurrence:

    phi_u(u)  ~ phi(sqrt(u))      on u in [r_lo^2, rc^2]   (u = r^2)
    rho_u(u)  ~ f_rho(sqrt(u))    on u in [r_lo^2, rc^2]
    F_q(q)    ~ F(q^2)            on q = sqrt(rho) in [q_lo, sqrt(rho_hi)]

Below r_lo (where phi reaches ~50 eV) the series is clamped flat: such a
pair carries beta*E >> 100 and every trial that makes one is rejected.
F is fit in q = sqrt(rho) because embedding functions go like -sqrt(rho)
near zero density. Derivative series (d/du, scaled to the fit interval)
give the virial: r dphi/dr = 2u phi_u'(u), and the embedding part
(F'_i + F'_j) 2u rho_u'.

The refit is the JAX package's: the spline samples are float32 (as the
JAX spline evaluation gives them), the least-squares fits and the degree
search float64, and the coefficients are stored as float32. ``tol`` is the
max fit error in eV; None reads ``$NM_EAM_TOL``, else 2e-4 (the
production default of the JAX package). The achieved max errors are on
``fit_err``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from numpy.polynomial import chebyshev as C

from neuralmelting_tpu_torch.models.eam import EAMAlloy, spline_eval

_SERIES = ("c_phi", "c_phid", "c_rho", "c_rhod", "c_f", "c_fd")
_SCALARS = ("rc", "u_lo", "u_hi", "rho_hi", "q_lo")


@dataclasses.dataclass(frozen=True)
class EAMCheb:
    """Chebyshev EAM; scalars are 0-d float32 arrays, series float32."""
    rc: np.ndarray           # () cutoff
    u_lo: np.ndarray         # () fit floor in u = r^2
    u_hi: np.ndarray         # () = rc^2
    rho_hi: np.ndarray       # () embedding fit ceiling (in rho)
    q_lo: np.ndarray         # () embedding fit floor (in q = sqrt(rho))
    c_phi: np.ndarray        # (dp+1,) phi(sqrt u)
    c_phid: np.ndarray       # (dp+1,) d/du of phi series (zero-padded)
    c_rho: np.ndarray        # (dr+1,) f_rho(sqrt u)
    c_rhod: np.ndarray       # (dr+1,)
    c_f: np.ndarray          # (df+1,) F(q^2), q = sqrt(rho)
    c_fd: np.ndarray         # (df+1,) dF/dq series
    rc_host: float = 6.0
    fit_err: tuple = ()

    @property
    def kind(self) -> str:
        return "eam-cheb"


def _fit(fn, a, b, tol, max_deg=30, samples=4000):
    """Least-squares Chebyshev fit of fn on [a, b] to max-error tol."""
    x = np.linspace(a, b, samples)
    y = fn(x)
    for deg in range(8, max_deg + 1, 2):
        t = 2.0 * (x - a) / (b - a) - 1.0
        c = C.chebfit(t, y, deg)
        err = float(np.max(np.abs(C.chebval(t, c) - y)))
        if err < tol:
            return c, err
    return c, err


def _der(c, a, b):
    """Series of d/dx on [a, b] (chain rule for the interval map)."""
    d = C.chebder(c) * (2.0 / (b - a))
    return np.concatenate([d, [0.0]])


def from_spline(eam: EAMAlloy, tol: float = None,
                phi_cap: float = 50.0) -> EAMCheb:
    """Refit an EAMAlloy's spline tables as Chebyshev series."""
    if tol is None:
        tol = float(os.environ.get("NM_EAM_TOL", "2e-4"))
    rc = float(eam.rc_host)
    drho = float(eam.drho)
    nrho = eam.f_coef.shape[1] + 1

    def sp(coef, dx):
        return lambda x: spline_eval(coef, dx, x)[0]

    rphi = sp(eam.rphi_coef, eam.dr)
    frho = sp(eam.rho_coef, eam.dr)
    femb = sp(eam.f_coef, eam.drho)

    # r_lo: where phi = rphi/r crosses phi_cap (scan from rc down)
    rr = np.linspace(0.05 * rc, rc, 2000)
    phi = rphi(rr) / rr
    above = np.nonzero(phi > phi_cap)[0]
    r_lo = rr[above[-1] + 1] if len(above) else rr[0]
    a, b = float(r_lo) ** 2, rc * rc

    c_phi, e_phi = _fit(lambda u: rphi(np.sqrt(u)) / np.sqrt(u), a, b,
                        tol, max_deg=36)
    c_rho, e_rho = _fit(lambda u: frho(np.sqrt(u)), a, b, tol)
    rho_hi = (nrho - 1) * drho
    q_hi = float(np.sqrt(rho_hi))
    # floor the fit at 2% of the table range (rho_lo = 2% of rho_hi): the
    # spline of the sqrt-like embedding wiggles in its first intervals,
    # and bulk densities never come near that corner
    q_lo = 0.141 * q_hi
    c_f, e_f = _fit(lambda q: femb(q * q), q_lo, q_hi, tol, max_deg=36)

    f32 = lambda v: np.asarray(v, np.float32)
    return EAMCheb(
        rc=f32(rc), u_lo=f32(a), u_hi=f32(b), rho_hi=f32(rho_hi),
        q_lo=f32(q_lo),
        c_phi=f32(c_phi), c_phid=f32(_der(c_phi, a, b)),
        c_rho=f32(c_rho), c_rhod=f32(_der(c_rho, a, b)),
        c_f=f32(c_f), c_fd=f32(_der(c_f, q_lo, q_hi)),
        rc_host=rc,
        fit_err=(float(e_phi), float(e_rho), float(e_f)))


def cheb_from_numpy(arrays: dict) -> EAMCheb:
    """An EAMCheb from plain arrays: the fields ``rc, u_lo, u_hi, rho_hi,
    q_lo`` and the six series, plus ``rc_host`` and ``fit_err``. Carries a
    series computed elsewhere (e.g. by the JAX package) across unchanged,
    so both sides evaluate identical coefficients."""
    f32 = lambda v: np.asarray(v, np.float32)
    kw = {k: f32(arrays[k]) for k in _SCALARS + _SERIES}
    return EAMCheb(**kw, rc_host=float(arrays.get("rc_host", kw["rc"])),
                   fit_err=tuple(arrays.get("fit_err", ())))


def cheb_eval(c, a, b, x):
    """Clenshaw evaluation of a Chebyshev series on [a, b] (torch; the
    model-level reference, in the JAX ``cheb_eval`` operation order).
    Clamps x into [a, b]: below-range pairs are impossibly repulsive and
    rejected regardless, above-range is masked by the cutoff."""
    dev = x.device
    c = torch.as_tensor(np.asarray(c, np.float32), device=dev)
    a = torch.as_tensor(np.float32(a), device=dev)
    b = torch.as_tensor(np.float32(b), device=dev)
    x = torch.clamp(x, a, b)
    t = 2.0 * (x - a) / (b - a) - 1.0
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + c[k], b1
    return t * b1 - b2 + c[0]
