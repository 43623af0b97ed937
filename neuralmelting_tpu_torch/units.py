"""Unit systems, mirroring the two the reference used via LAMMPS (the
port's own copy of ``neuralmelting_tpu.units``).

The reference drove LAMMPS with ``units lj`` for Lennard-Jones runs and
``units metal`` for EAM aluminum (SURVEY.md §2 row 3). Only the constants
actually needed by the NPT Metropolis weight and thermo output are defined:

* ``kb``     — Boltzmann constant in the system's energy/temperature units.
* ``p2e``    — converts (pressure unit) x (volume unit) into energy units,
               used in the P*dV term of the NPT acceptance.

lj:    energy eps, length sigma, T in eps/kb  -> kb = 1, p2e = 1.
metal: energy eV, length Angstrom, T in K, P in bar
       -> kb = 8.617333262e-5 eV/K,  1 bar*A^3 = 1e-25 J = 6.241509e-7 eV.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    name: str
    kb: float    # Boltzmann constant [energy / temperature]
    p2e: float   # pressure * volume -> energy conversion factor


LJ = UnitSystem(name="lj", kb=1.0, p2e=1.0)
METAL = UnitSystem(name="metal", kb=8.617333262e-5, p2e=1.0 / 1.602176634e6)

_SYSTEMS = {"lj": LJ, "metal": METAL}


def get(name: str) -> UnitSystem:
    try:
        return _SYSTEMS[name]
    except KeyError:
        raise ValueError(f"unknown unit system {name!r}; choose from {sorted(_SYSTEMS)}")
