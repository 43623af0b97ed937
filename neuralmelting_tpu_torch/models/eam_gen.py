"""Synthetic aluminum setfl table generator (the port's own copy of
``neuralmelting_tpu.models.eam_gen``; it writes the same table).

The reference shipped a published tabulated potential (Al99.eam.alloy-style;
SURVEY.md §2.1). The repository ships no published table, so we generate a
physically-reasonable analytic EAM for fcc aluminum and tabulate it in
standard setfl format — exercising the exact same parser -> spline -> kernel
path a published file would. Documented deviation: melting-point numbers for
"AL" refer to THIS parameterization, not to Al99.eam.alloy.

Functional forms (Johnson/Oh-style):
    rho(r)  = fe * exp(-beta (r - re)) * S(r)
    phi(r)  = [A exp(-alpha (r - re)) - B exp(-gamma (r - re))] * S(r)
    F(rho)  = -F0 [1 - eta ln(rho/rhoe)] (rho/rhoe)^eta
with S(r) a quintic switching function that is 1 below rs and 0 at rc.
Parameters chosen to give a cohesive energy near -3.36 eV/atom and
near-zero pressure at a = 4.05 A (checked in tests/test_eam.py).
"""

from __future__ import annotations

import numpy as np

# Al parameters, least-squares fitted so the fcc crystal at a = 4.05 A has
# cohesive energy -3.360 eV/atom and zero virial pressure (equilibrium),
# with compression at a=3.90 and tension at a=4.20 (see tests/test_eam.py).
RE = 4.05 / np.sqrt(2.0)      # nearest-neighbor distance
RC = 6.0
RS = 4.9
FE = 1.0
BETA = 3.0
A_REP = 0.27078279
ALPHA = 7.14309282
B_ATT = 0.66546941
GAMMA = 2.85
F0 = 0.90908633
ETA = 0.5
RHOE = 10.0                   # approx fcc 12-neighbor density at re


def _switch(r, rc=None, rs=None):
    """Quintic smooth step: 1 for r<=rs, 0 for r>=rc, C2 in between."""
    rc = RC if rc is None else rc
    rs = RS if rs is None else rs
    t = np.clip((r - rs) / (rc - rs), 0.0, 1.0)
    return 1.0 - t ** 3 * (10.0 - 15.0 * t + 6.0 * t * t)


def rho_f(r, rc=None, rs=None):
    return FE * np.exp(-BETA * (r - RE)) * _switch(r, rc, rs)


def phi_f(r, rc=None, rs=None):
    return (A_REP * np.exp(-ALPHA * (r - RE))
            - B_ATT * np.exp(-GAMMA * (r - RE))) * _switch(r, rc, rs)


def embed_f(rho):
    x = np.maximum(rho / RHOE, 1e-12)
    return -F0 * (1.0 - ETA * np.log(x)) * x ** ETA


def write_setfl(path: str, nrho: int = 5000, nr: int = 5000,
                rhomax: float = 60.0, rc: float = None, rs: float = None):
    """rc/rs override the table cutoff (shorter-ranged variants for tests)."""
    rc = RC if rc is None else rc
    rs = (rc - (RC - RS)) if rs is None and rc != RC else (RS if rs is None else rs)
    drho = rhomax / nrho
    dr = rc / nr
    rho_grid = np.arange(nrho) * drho
    r_grid = np.arange(nr) * dr
    f_vals = embed_f(rho_grid)
    f_vals[0] = 0.0  # F(0) = 0 by convention
    rho_vals = rho_f(r_grid, rc, rs)
    rho_vals[r_grid < 0.5] = rho_f(0.5, rc, rs)   # clamp unphysical core
    rphi_vals = r_grid * np.where(r_grid < 0.5, phi_f(0.5, rc, rs),
                                  phi_f(r_grid, rc, rs))

    with open(path, "w") as f:
        f.write("synthetic Al EAM (neuralmelting_tpu models/eam_gen.py)\n")
        f.write("analytic Johnson/Oh-style forms; NOT Al99.eam.alloy\n")
        f.write("generated offline for the tabulated-potential pipeline\n")
        f.write("1 Al\n")
        f.write(f"{nrho} {drho:.16e} {nr} {dr:.16e} {rc:.16e}\n")
        f.write(f"13 26.9815385 4.05 fcc\n")
        for arr in (f_vals, rho_vals, rphi_vals):
            for i in range(0, len(arr), 5):
                f.write(" ".join(f"{x:.16e}" for x in arr[i:i + 5]) + "\n")
    return path
