"""The counts behind chip_smoke.py's bounds of B1 and B4, held to brute
force on the CPU.

chip_smoke charges B1 and B4 for each unordered candidate pair of the
half stencil that the kernels' box test keeps, for each box test
(``half_candidates``: a cell's own pairs, and each atom against the
half-stencil cells whose bounding box lies within the cutoff) and for
each pair inside the cutoff (``pairs_within``: ordered pairs over the
27-cell stencil). Each must equal a count over the atoms of the replica
one by one: each atom against every cell at a lexicographically positive
periodic offset in {-1, 0, 1}^3, that cell's box built from its atoms at
the image the offset reaches; and the ordered pairs closer than rc by the
minimum image. Inputs are seeded jittered fcc replicas binned by the
port, for the LJ stride-2 and the EAM stride-3 geometry.
"""

import itertools

import os
import sys

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cellmc_geom as CG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

R = 2
# (lattice constant, fcc cells per axis, rc, stride, nsub): the LJ test
# geometry ((4,4,4) cells) and an EAM one with six cells per axis
CASES = {"lj": (2.0 ** (2.0 / 3.0), 4, 1.5, 2, 16),
         "eam": (4.05, 6, 3.8, 3, 1)}


def _case(name):
    a0, ncells, rc, stride, nsub = CASES[name]
    pos, box = make_supercell("fcc", a0, ncells)
    box = np.asarray(box, np.float32)
    g = np.random.default_rng(len(name))
    pos = np.stack([(pos + 0.05 * a0 * g.standard_normal(pos.shape)) % box
                    for _ in range(R)]).astype(np.float32)
    boxes = np.repeat(box[None], R, 0)
    geom = CG.make_geom(box, rc, pos.shape[1], nsub=nsub, stride=stride)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.tensor([0.3, 0.65, 0.11]))
    assert not bool(over)
    params = torch.as_tensor(np.concatenate(
        [np.ones((R, 2)), boxes / np.asarray(geom.ncell), boxes],
        1).astype(np.float32))
    return geom, (x, y, z), ids, count, params, rc


def _atoms(geom, slabs, ids, r):
    """Replica r's atoms: slab positions (N, 3) f64 and cells (N, 3)."""
    occ = (ids[r] >= 0).numpy()
    xyz = np.stack([a[r].numpy()[occ] for a in slabs], 1).astype(np.float64)
    cells = CG.geom_tables(geom).T[occ]
    return xyz, cells


@pytest.mark.parametrize("name", list(CASES))
def test_half_candidates_match_brute_force(name):
    geom, slabs, ids, count, params, rc = _case(name)
    cut2 = np.float32(rc) * np.float32(rc)
    n = np.asarray(geom.ncell)
    positive = [d for d in itertools.product((-1, 0, 1), repeat=3)
                if d > (0, 0, 0)]
    kept = tests = skipped = 0
    for r in range(R):
        xyz, cells = _atoms(geom, slabs, ids, r)
        xyz = xyz.astype(np.float32)
        box = params[r, 5:8].numpy()
        key = [tuple(c) for c in cells]
        members = {}
        for i, c in enumerate(key):
            members.setdefault(c, []).append(i)
        lo = {c: xyz[ix].min(0) for c, ix in members.items()}
        hi = {c: xyz[ix].max(0) for c, ix in members.items()}
        kept += sum(len(ix) * (len(ix) - 1) // 2 for ix in members.values())
        for i, c in enumerate(key):
            for d in positive:
                full = np.asarray(c) + d
                other = tuple(full % n)
                if other not in members:
                    continue
                sh = (full // n).astype(np.float32) * box
                g = np.maximum(np.maximum((lo[other] + sh) - xyz[i],
                                          xyz[i] - (hi[other] + sh)),
                               np.float32(0))
                g2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
                tests += 1
                if g2 < cut2:
                    kept += len(members[other])
                else:
                    skipped += 1
    got = chip_smoke.half_candidates(geom, slabs, params, count, float(cut2))
    assert got == (kept, tests)
    assert kept > 0 and skipped > 0


@pytest.mark.parametrize("name", list(CASES))
def test_pairs_within_match_brute_force(name):
    geom, slabs, ids, _, params, rc = _case(name)
    rc2 = np.float32(rc) * np.float32(rc)
    want = 0
    for r in range(R):
        xyz, _ = _atoms(geom, slabs, ids, r)
        box = params[r, 5:8].numpy().astype(np.float64)
        d = xyz[:, None, :] - xyz[None, :, :]
        d -= box * np.round(d / box)
        r2 = (d * d).sum(-1)
        np.fill_diagonal(r2, np.inf)
        want += int((r2 < rc2).sum())
    assert chip_smoke.pairs_within(geom, slabs, params, float(rc2)) == want
    assert want > 0
