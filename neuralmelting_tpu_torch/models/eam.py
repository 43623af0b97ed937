"""Tabulated EAM (embedded-atom method) potential — setfl format (the
port's counterpart of ``neuralmelting_tpu.models.eam``).

The host-side parser reads the standard single-element setfl layout;
tables become natural cubic splines, kept as numpy in ``EAMAlloy``. Two
engines read them: the cellmc engine samples their Chebyshev refit
(``models/eam_cheb.py``), which samples the splines on the host through
the numpy ``spline_eval``; the gather engine evaluates the splines
themselves on the run's device, from ``EAMTables`` (``to_device``) and
the torch ``spline_eval_t``.

Energy model:
    E = sum_i F(rho_i) + 1/2 sum_{i!=j} phi(r_ij),   rho_i = sum_j rho(r_ij)
where setfl stores F on a rho-grid, rho(r) on an r-grid, and r*phi(r) on the
same r-grid (the z2r convention).

Both ``spline_eval`` forms work in float32 with the JAX version's
operation order (that version runs in f32, jax without x64): the
Chebyshev refit samples the splines, and equal samples give equal
series; the gather engine's energies then differ from the JAX engine's
by f32 rounding only (XLA on the CPU contracts the Horner steps into
multiply-adds, torch does not).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EAMAlloy:
    """Single-element setfl EAM with cubic-spline tables (numpy f32).

    Spline coefficient arrays have shape (4, n-1): value a + u*(b + u*(c + u*d))
    on interval [i, i+1) with u = x/dx - i.
    """
    rc: np.ndarray           # () f32 cutoff of the pair/density tables
    dr: np.ndarray           # () f32 r-grid spacing
    drho: np.ndarray         # () f32 rho-grid spacing
    f_coef: np.ndarray       # (4, nrho-1) embedding F(rho)
    rho_coef: np.ndarray     # (4, nr-1) density rho(r)
    rphi_coef: np.ndarray    # (4, nr-1) r*phi(r)
    rc_host: float = 6.0

    @property
    def kind(self) -> str:
        return "eam"


@dataclasses.dataclass(frozen=True, eq=False)
class EAMTables:
    """An ``EAMAlloy``'s spline tables on the run's device: the gather
    engine's potential. ``rc``, ``dr`` and ``drho`` are 0-dim f32 tensors
    (a tensor divisor makes ``x / dr`` a true division on the card too);
    ``rc_host`` is the cutoff as a host float, for cell and list sizes.
    It hashes by identity: a run function and its CUDA graphs belong to
    one table object."""
    rc: torch.Tensor         # () f32
    dr: torch.Tensor         # () f32
    drho: torch.Tensor       # () f32
    f_coef: torch.Tensor     # (4, nrho-1) f32
    rho_coef: torch.Tensor   # (4, nr-1) f32
    rphi_coef: torch.Tensor  # (4, nr-1) f32
    rc_host: float = 6.0

    @property
    def kind(self) -> str:
        return "eam"


def to_device(eam: EAMAlloy, device) -> EAMTables:
    """The tables of ``eam`` as f32 tensors on ``device``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return EAMTables(rc=t(eam.rc), dr=t(eam.dr), drho=t(eam.drho),
                     f_coef=t(eam.f_coef), rho_coef=t(eam.rho_coef),
                     rphi_coef=t(eam.rphi_coef), rc_host=float(eam.rc_host))


@dataclasses.dataclass
class SetflData:
    """Raw parsed setfl content (host side)."""
    comments: list
    element: str
    atomic_number: int
    mass: float
    lattice_const: float
    lattice: str
    nrho: int
    drho: float
    nr: int
    dr: float
    rc: float
    f_rho: np.ndarray    # (nrho,)
    rho_r: np.ndarray    # (nr,)
    rphi_r: np.ndarray   # (nr,) == r * phi(r)


def parse_setfl(path: str) -> SetflData:
    """Parse a single-element setfl (eam/alloy) file."""
    with open(path) as f:
        lines = f.read().split("\n")
    comments = lines[:3]
    head = lines[3].split()
    nelem = int(head[0])
    if nelem != 1:
        raise ValueError(f"only single-element setfl supported, got {nelem}")
    element = head[1]
    grid = lines[4].split()
    nrho, drho, nr, dr, rc = (int(grid[0]), float(grid[1]), int(grid[2]),
                              float(grid[3]), float(grid[4]))
    elem_line = lines[5].split()
    atomic_number = int(float(elem_line[0]))
    mass = float(elem_line[1])
    lattice_const = float(elem_line[2])
    lattice = elem_line[3] if len(elem_line) > 3 else "fcc"

    vals = []
    for line in lines[6:]:
        vals.extend(float(x) for x in line.split())
    vals = np.asarray(vals, np.float64)
    need = nrho + 2 * nr
    if len(vals) < need:
        raise ValueError(f"setfl too short: {len(vals)} < {need}")
    f_rho = vals[:nrho]
    rho_r = vals[nrho:nrho + nr]
    rphi_r = vals[nrho + nr:nrho + 2 * nr]
    return SetflData(comments, element, atomic_number, mass, lattice_const,
                     lattice, nrho, drho, nr, dr, rc, f_rho, rho_r, rphi_r)


def _natural_cubic_coefs(y: np.ndarray) -> np.ndarray:
    """Natural cubic spline on a unit grid -> (4, n-1) coefficients."""
    n = len(y)
    # solve tridiagonal system for second derivatives m
    m = np.zeros(n)
    if n > 2:
        a = np.ones(n - 2)
        b = np.full(n - 2, 4.0)
        rhs = 6.0 * (y[2:] - 2 * y[1:-1] + y[:-2])
        # Thomas algorithm
        cp = np.zeros(n - 2)
        dp = np.zeros(n - 2)
        cp[0] = a[0] / b[0]
        dp[0] = rhs[0] / b[0]
        for i in range(1, n - 2):
            denom = b[i] - a[i] * cp[i - 1]
            cp[i] = a[i] / denom if i < n - 3 else 0.0
            dp[i] = (rhs[i] - a[i] * dp[i - 1]) / denom
        m[n - 2] = dp[-1]
        for i in range(n - 4, -1, -1):
            m[i + 1] = dp[i] - cp[i] * m[i + 2]
    a0 = y[:-1]
    b0 = (y[1:] - y[:-1]) - (2 * m[:-1] + m[1:]) / 6.0
    c0 = m[:-1] / 2.0
    d0 = (m[1:] - m[:-1]) / 6.0
    return np.stack([a0, b0, c0, d0]).astype(np.float32)


def from_setfl(data: SetflData) -> EAMAlloy:
    return EAMAlloy(
        rc=np.float32(data.rc),
        dr=np.float32(data.dr),
        drho=np.float32(data.drho),
        f_coef=_natural_cubic_coefs(data.f_rho),
        rho_coef=_natural_cubic_coefs(data.rho_r),
        rphi_coef=_natural_cubic_coefs(data.rphi_r),
        rc_host=float(data.rc),
    )


def load(path: str) -> EAMAlloy:
    return from_setfl(parse_setfl(path))


def spline_eval(coef, dx, x):
    """Spline value and derivative at x (any shape), in float32."""
    coef = np.asarray(coef, np.float32)
    dx = np.float32(dx)
    x = np.asarray(x, np.float32)
    n = coef.shape[1]
    t = x / dx
    i = np.clip(t.astype(np.int32), 0, n - 1)
    u = t - i.astype(np.float32)
    a, b, c, d = coef[0, i], coef[1, i], coef[2, i], coef[3, i]
    val = ((d * u + c) * u + b) * u + a
    der = ((np.float32(3.0) * d * u + np.float32(2.0) * c) * u + b) / dx
    return val, der


def _locate(n, dx, x):
    """The interval i of x on a grid of n intervals of spacing dx and the
    offset u = x / dx - i within it, as the JAX ``spline_eval`` takes them
    (its int32 cast and clip give the same i for |x / dx| < 2^31)."""
    t = x / dx
    i = torch.clamp(t.to(torch.int64), 0, n - 1)
    return i, t - i.to(t.dtype)


def spline_eval_t(coef, dx, x):
    """Spline value and derivative at x (a tensor of any shape, f32) on
    x's device: ``coef`` (4, n-1) and the 0-dim spacing ``dx`` tensors
    there (``EAMTables``), in the JAX operation order."""
    i, u = _locate(coef.shape[1], dx, x)
    a, b, c, d = coef[:, i].unbind(0)
    val = ((d * u + c) * u + b) * u + a
    der = ((3.0 * d * u + 2.0 * c) * u + b) / dx
    return val, der


def spline_vals_t(coefs, dx, x):
    """The values alone of one or more tables on one grid at x, located
    once: each equals ``spline_eval_t``'s value bit for bit (the trial
    moves need no derivative, and fewer device operations a move)."""
    i, u = _locate(coefs[0].shape[1], dx, x)
    out = []
    for coef in coefs:
        a, b, c, d = coef[:, i].unbind(0)
        out.append(((d * u + c) * u + b) * u + a)
    return tuple(out)


def interaction_range(pot) -> float:
    """Cell-decomposition independence range (host side): 2 rc for EAM,
    whose moves couple through the neighbours' densities."""
    rc = float(pot.rc_host)
    return 2.0 * rc if getattr(pot, "kind", "pair") == "eam" else rc
