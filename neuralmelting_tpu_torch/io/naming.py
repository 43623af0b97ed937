"""Run and sample file naming (counterpart of ``neuralmelting_tpu.io.naming``).

Run identity lives in dotted file prefixes
(``<name>.<element>.<lattice>.<size>.<press>.<temp>``): one ``.thrm`` and
one ``.traj`` per (P, T) grid point.
"""

from __future__ import annotations

import os


def run_prefix(name: str, element: str, lattice: str, ncells) -> str:
    if isinstance(ncells, (tuple, list)):
        size = "x".join(str(int(c)) for c in ncells)
    else:
        size = str(int(ncells))
    return f"{name}.{element.lower()}.{lattice}.{size}"


def sample_prefix(name: str, element: str, lattice: str, ncells,
                  p_idx: int, t_idx: int) -> str:
    return f"{run_prefix(name, element, lattice, ncells)}.{p_idx:02d}.{t_idx:02d}"


def sample_paths(outdir: str, prefix: str):
    return (os.path.join(outdir, prefix + ".thrm"),
            os.path.join(outdir, prefix + ".traj"))
