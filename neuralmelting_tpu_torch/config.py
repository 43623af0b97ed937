"""Run configuration: ``PotentialSpec``, ``ElementSpec``, ``ELEMENTS``,
``RunConfig`` and ``grids`` — the port's own copy of
``neuralmelting_tpu.config`` (the port imports nothing of the JAX
package). ``RunConfig.to_json()`` gives the same text as the JAX class for
the same fields, so configurations move between the two packages.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PotentialSpec:
    """Which potential to run. style in {"lj/cut", "eam/alloy"}."""
    style: str = "lj/cut"
    # lj/cut parameters
    eps: float = 1.0
    sigma: float = 1.0
    rc: float = 2.5
    # eam/alloy parameters
    setfl: Optional[str] = None  # path to a setfl table file


@dataclasses.dataclass(frozen=True)
class ElementSpec:
    """Per-element physics defaults (reference: dicts in lammps_remcmc.py)."""
    name: str
    units: str                      # "lj" | "metal"
    lattice: str                    # "fcc" | "bcc" | "sc"
    lat_const: float                # conventional lattice constant
    mass: float
    potential: PotentialSpec
    t_range: Tuple[float, float]    # default temperature sweep bounds
    p_range: Tuple[float, float]    # default pressure sweep bounds
    dt: float                       # HMC timestep


# Built-in elements. "LJ" is the reduced-unit Lennard-Jones system; "AL" is
# EAM aluminum via a tabulated setfl file (reference: Al99.eam.alloy-style).
ELEMENTS = {
    "LJ": ElementSpec(
        name="LJ",
        units="lj",
        lattice="fcc",
        lat_const=2.0 ** (2.0 / 3.0),  # fcc a for nearest-neighbor r = 2^(1/6) sigma
        mass=1.0,
        potential=PotentialSpec(style="lj/cut", eps=1.0, sigma=1.0, rc=2.5),
        t_range=(0.25, 2.5),
        p_range=(1.0, 8.0),
        dt=0.005,
    ),
    "AL": ElementSpec(
        name="AL",
        units="metal",
        lattice="fcc",
        lat_const=4.05,
        mass=26.9815385,
        potential=PotentialSpec(style="eam/alloy", setfl=None),  # setfl set at run time
        t_range=(256.0, 2560.0),
        p_range=(1.0, 312500.0),  # bar
        dt=0.00390625,
    ),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Full sampler run description (reference: lammps_remcmc.py CLI)."""
    name: str = "remcmc"
    element: str = "LJ"
    ncells: Tuple[int, int, int] = (4, 4, 4)
    npress: int = 4
    ntemp: int = 16
    press: Optional[Tuple[float, ...]] = None   # explicit grid overrides npress
    temp: Optional[Tuple[float, ...]] = None
    # move mix: probabilities of position / volume / HMC moves per sweep slot
    ppos: float = 0.96875
    pvol: float = 0.03125
    phmc: float = 0.0
    nsmpl: int = 64          # number of recorded samples (cycles after cutoff)
    mod: int = 32            # sweeps between records / step-size adaptations
    ncut: int = 16           # burn-in records discarded by downstream stages
    nstps: int = 16          # HMC leapfrog steps per move
    seed: int = 256
    # initial step sizes (fractions of box / volume)
    dpos0: float = 0.125     # initial max displacement, units of sigma/Angstrom
    dvol0: float = 0.015625  # initial max fractional volume change
    # adaptation
    acc_target_pos: float = 0.5
    acc_target_vol: float = 0.5
    acc_target_hmc: float = 0.5
    adapt_factor: float = 1.0625
    # cellmc engine schedules (sampler/cellmc.py): run the nvol volume
    # trials (a full-energy pass each) every vol_every-th sweep and the
    # grid-shift rebin sort every rebin_every-th — valid deterministic
    # Markov schedules; the reference's pvol~0.03 mix attempts volume
    # trials even less often per position trial at N=4096
    vol_every: int = 4
    rebin_every: int = 2
    # neighbor list
    skin: float = 0.4
    max_neighbors: int = 0   # 0 -> auto
    # execution
    mode: str = "auto"       # "serial" | "checkerboard" | "auto"
    write_traj: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        d = json.loads(s)
        for k in ("ncells", "press", "temp"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


def grids(cfg: RunConfig):
    """Resolve the (P, T) grids from a RunConfig + its element defaults."""
    import numpy as np

    el = ELEMENTS[cfg.element]
    if cfg.press is not None:
        press = np.asarray(cfg.press, dtype=np.float64)
    else:
        press = np.linspace(el.p_range[0], el.p_range[1], cfg.npress)
    if cfg.temp is not None:
        temp = np.asarray(cfg.temp, dtype=np.float64)
    else:
        temp = np.linspace(el.t_range[0], el.t_range[1], cfg.ntemp)
    return press, temp
