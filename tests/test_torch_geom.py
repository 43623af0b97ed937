"""Port parity: slab geometry and bin / unbin / rebin, bit for bit.

ops/cellmc_geom.py against the JAX package's ops/pallas/cellmc.py helpers
on the same inputs (numpy, seeded), at two geometries: rc=1.5 gives a
(4,4,4) cell grid whose within-colour grid is 2^3 (real wrap rows), and
rc=2.5 the degenerate (2,2,2) grid.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu.ops.pallas import cellmc as CM
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cellmc_geom as CG

R = 2


def _inputs(rc, seed=0):
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), 4)   # 256 atoms
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + 0.05 * g.standard_normal(pos.shape)) % box
                    for _ in range(R)]).astype(np.float32)
    boxes = np.stack([box * np.float32(1.0 + 0.01 * i)
                      for i in range(R)]).astype(np.float32)
    pos = (pos * (boxes[:, None, :] / box)).astype(np.float32)
    shift = np.asarray([0.23, 0.61, 0.07], np.float32)
    return pos, boxes, shift, CG.make_geom(box, rc, pos.shape[1])


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("rc,nsub,kcap", [(1.5, 16, 0), (2.5, 16, 0),
                                          (2.5, 8, 40), (1.2, 4, 0)])
def test_make_geom_and_tables_match_jax(rc, nsub, kcap):
    _, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), 4)
    gj = CM.make_geom(box, rc, 256, nsub=nsub, kcap=kcap)
    gt = CG.make_geom(box, rc, 256, nsub=nsub, kcap=kcap)
    assert (gt.ncell, gt.kcap, gt.nsub, gt.natoms, gt.stride) == \
        (gj.ncell, gj.kcap, gj.nsub, gj.natoms, gj.stride)
    assert (gt.cw, gt.rows, gt.half) == (gj.cw, gj.rows, gj.half)
    np.testing.assert_array_equal(CG.geom_tables(gt), CM.geom_tables(gj))
    for maxcount in (0, 5, 31, 44, 60):
        assert CG.tight_kcap(maxcount, nsub) == CM.tight_kcap(maxcount, nsub)
    c3 = np.stack(np.meshgrid(*[np.arange(n) for n in gt.ncell],
                              indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_array_equal(CG.scid(gt, c3),
                                  np.asarray(CM._scid(gj, jnp.asarray(c3))))


@pytest.mark.parametrize("rc", [1.5, 2.5])
def test_bin_unbin_match_jax(rc):
    pos, boxes, shift, geom = _inputs(rc)
    gj = CM.make_geom(boxes[0] / np.float32(1.0), rc, pos.shape[1])
    assert gj.ncell == geom.ncell and gj.kcap == geom.kcap
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.as_tensor(shift))
    assert not bool(over)
    for r in range(R):
        jx, jy, jz, jids, jcount, jover = CM.bin_initial(
            gj, jnp.asarray(pos[r]), jnp.asarray(boxes[r]),
            jnp.asarray(shift))
        assert not bool(jover)
        for a, b in ((x, jx), (y, jy), (z, jz)):
            _same_bits(a[r].numpy(), b)
        np.testing.assert_array_equal(ids[r].numpy(), np.asarray(jids))
        np.testing.assert_array_equal(count[r].numpy(), np.asarray(jcount))
    back = CG.unbin(geom, (x, y, z, ids), torch.as_tensor(boxes),
                    torch.as_tensor(shift))
    for r in range(R):
        jb = CM.unbin(gj, (jnp.asarray(x[r].numpy()),
                           jnp.asarray(y[r].numpy()),
                           jnp.asarray(z[r].numpy()),
                           jnp.asarray(ids[r].numpy())),
                      jnp.asarray(boxes[r]), jnp.asarray(shift))
        _same_bits(back[r].numpy(), jb)
    assert float((back - torch.as_tensor(pos)).abs().max()) < 2e-5


@pytest.mark.parametrize("rc", [1.5, 2.5])
def test_rebin_axis_matches_jax(rc):
    pos, boxes, shift, geom = _inputs(rc, seed=1)
    x, y, z, ids, count, _ = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.as_tensor(shift))
    gj = CM.make_geom(boxes[0], rc, pos.shape[1])
    tslabs = (x, y, z, ids)
    jslabs = tuple(jnp.asarray(a.numpy()) for a in tslabs)
    jcount = jnp.asarray(count.numpy())
    sh = torch.as_tensor(shift)
    g = np.random.default_rng(2)
    for step, axis in enumerate((0, 1, 2, 1)):
        delta = np.float32(g.uniform(0.0, 0.9) / geom.ncell[axis])
        tab = CG.geom_tables(geom)[axis]
        tslabs, count, over = CG.rebin_axis(
            geom, tslabs, count, torch.as_tensor(boxes),
            torch.as_tensor(delta), axis, cell_tab=torch.as_tensor(tab))
        jslabs, jcount, jover = CM.rebin_axis(
            gj, jslabs, jcount, jnp.asarray(boxes), jnp.asarray(delta),
            axis, cell_tab=jnp.asarray(tab))
        assert bool(over) == bool(jover) is False
        for a, b in zip(tslabs[:3], jslabs[:3]):
            _same_bits(a.numpy(), b)
        np.testing.assert_array_equal(tslabs[3].numpy(), np.asarray(jslabs[3]))
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
        sh = sh.clone()
        sh[axis] += torch.as_tensor(delta)
    assert (count.sum(dim=1) == pos.shape[1]).all()
    back = CG.unbin(geom, tslabs, torch.as_tensor(boxes), sh)
    assert float((back - torch.as_tensor(pos)).abs().max()) < 2e-5
    occ = (tslabs[3].reshape(R, geom.ncells, geom.kcap) >= 0).to(torch.int32)
    assert (torch.diff(occ, dim=-1) <= 0).all()        # packed first


def test_rebin_overflow_is_flagged():
    pos, boxes, shift, geom = _inputs(1.5, seed=3)
    x, y, z, ids, count, _ = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.as_tensor(shift))
    # slide by most of a cell: cells receive most of their lower
    # neighbour's atoms; with a cap of max-occupancy the 2K sort overflows
    import dataclasses
    kc = int(count.max())
    tight = dataclasses.replace(geom, kcap=-(-kc // 8) * 8)
    x, y, z, ids, count, over = CG.bin_initial(
        tight, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.as_tensor(shift))
    assert not bool(over)
    flags = []
    for axis in range(3):
        (x, y, z, ids), count, over = CG.rebin_axis(
            tight, (x, y, z, ids), count, torch.as_tensor(boxes),
            0.45 / tight.ncell[axis], axis)
        flags.append(bool(over))
    nvalid = (ids >= 0).sum(dim=1)
    assert any(flags) == bool((nvalid < pos.shape[1]).any())
