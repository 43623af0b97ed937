"""Port parity: kernel B3 (the EAM position sweep), plain PyTorch version,
and the stride-3 slab geometry it runs on.

ops/cellmc_eam.py ``sweep`` on CPU tensors (its plain version) against the
JAX package's Pallas ``make_eam_sweep_fn`` in interpret mode: one ncyc=1
sweep (27 colour steps) from the same slabs, density slab and threefry
keys (tests/test_torch_eam_case.py: 256 atoms, cells (3,3,3) — one cell
per colour, whose +-1 neighbours wrap to the other two cells — K=16), at
R=2 (one lane tile) and at R=3 with rt=2 (two tiles, the second
lane-padded).
Tolerances: n_try and n_acc identical; positions within 1e-6; the density
slab within 2e-5 absolute of the JAX slab and of a fresh B4 pass at the
final positions (rho ~ 13); the tracked dE within 2e-3 + 1e-4 |dE| of
E(final) - E(initial) from two B4 passes. Geometry helpers (make_geom,
geom_tables, the stencil, bin_initial, rebin with the density slab as an
extra) equal the JAX ones at stride 3, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu.ops.pallas import cellmc as CM
from neuralmelting_tpu.ops.pallas import cellmc_eam as JCE

import test_torch_eam_case as eam_case
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.sampler import cellmc as SC

CASES = {"r2": ((300.0, 1200.0), 2), "r3": ((300.0, 800.0, 1400.0), 2)}


@pytest.fixture(scope="module")
def cheb(tmp_path_factory):
    return eam_case.chebs(eam_case.write_table(
        tmp_path_factory.mktemp("eam")))[1]


@pytest.fixture(scope="module", params=list(CASES))
def swept(request, cheb):
    temps, rt = CASES[request.param]
    c = eam_case.case(cheb, temps, seed=len(temps))
    r, geom = c["r"], c["geom"]
    ones = torch.ones(r)
    e0, rho0 = CE.total(geom, c["slabs"], c["params"], c["scal"],
                        c["series"], ones, False)
    seeds = SC.tile_seeds((21, 22), 5, -(-r // rt), "cpu")
    port = tuple(a.clone() for a in c["slabs"]) + (rho0.clone(),)
    st = CE.sweep(geom, 1, rt, port, c["count"], c["params"], c["scal"],
                  c["series"], seeds)
    sw = JCE.make_eam_sweep_fn(eam_case.jax_geom(c), ncyc=1, nser=c["nser"],
                               interpret=True, rt=rt)
    jser = tuple(jnp.asarray(c["series"][i].numpy()) for i in (0, 2, 4))
    (jx, jy, jz, jrho), jst = sw(
        tuple(eam_case.jt(a) for a in c["slabs"]) + (eam_case.jt(rho0),),
        eam_case.jt(c["count"]), eam_case.jt(c["params"]),
        jnp.asarray(c["scal"].numpy()), jser, jnp.asarray(seeds.numpy()))
    e1, rho1 = CE.total(geom, port[:3], c["params"], c["scal"], c["series"],
                        ones, False)
    c.update(port=port, st=st.numpy(), e0=e0[:, 0], e1=e1[:, 0], rho1=rho1,
             jslabs=[np.array(a).T for a in (jx, jy, jz, jrho)],
             jst=np.array(jst).T, ok=c["ids"].numpy() >= 0)
    return c


def test_sweep_decisions_match_jax(swept):
    st, jst = swept["st"], swept["jst"]
    np.testing.assert_array_equal(st[:, 2], jst[:, 2])       # n_try
    np.testing.assert_array_equal(st[:, 1], jst[:, 1])       # n_acc
    assert (st[:, 2] == 27).all() and (st[:, 1] > 0).all()
    assert (st[:, 3:] == 0).all()


def test_sweep_positions_and_rho_match_jax(swept):
    ok = swept["ok"]
    for a in range(3):
        d = np.abs(swept["port"][a].numpy() - swept["jslabs"][a])[ok]
        assert d.max() <= 1e-6
    d = np.abs(swept["port"][3].numpy() - swept["jslabs"][3])[ok]
    assert d.max() < 2e-5
    np.testing.assert_allclose(swept["st"][:, 0], swept["jst"][:, 0],
                               rtol=1e-4, atol=1e-4)


def test_sweep_rho_equals_a_fresh_pass(swept):
    ok = swept["ok"]
    rho = swept["port"][3].numpy()
    assert np.abs(rho - swept["rho1"].numpy())[ok].max() < 2e-5
    assert (rho[~ok] == 0).all()


def test_sweep_tracked_de_matches_energy_change(swept):
    tracked = swept["st"][:, 0].astype(np.float64)
    true = (swept["e1"] - swept["e0"]).numpy().astype(np.float64)
    assert (np.abs(tracked - true) < 2e-3 + 1e-4 * np.abs(true)).all(), \
        (tracked, true)


def test_sweep_keeps_atoms_in_their_cells(swept):
    geom, params, ok = swept["geom"], swept["params"], swept["ok"]
    tabs = torch.as_tensor(CG.geom_tables(geom))
    for a in range(3):
        lo = tabs[a][None].to(torch.float32) * params[:, 2 + a, None]
        v = swept["port"][a]
        inside = (v >= lo) & (v < lo + params[:, 2 + a, None])
        assert bool(inside[torch.as_tensor(ok)].all())


@pytest.mark.parametrize("cells", [(4, 4, 4), (16, 8, 8)])
def test_stride3_geometry_matches_jax(cells):
    """make_geom, geom_tables, scid and bin_initial at stride 3, nsub 1,
    and the stencil (neighbour slab cells and image signs) against the
    JAX geometry tables."""
    pos, box = make_supercell("fcc", 4.05, cells)
    n = pos.shape[0]
    gj = CM.make_geom(box, 3.8, n, nsub=1, stride=3)
    gt = CG.make_geom(box, 3.8, n, nsub=1, stride=3)
    assert (gt.ncell, gt.kcap, gt.nsub, gt.stride, gt.cw, gt.half) == \
        (gj.ncell, gj.kcap, gj.nsub, gj.stride, gj.cw, gj.half)
    np.testing.assert_array_equal(CG.geom_tables(gt), CM.geom_tables(gj))
    cfull = CM.geom_tables(gj)[:, ::gj.kcap].T                 # (C, 3)
    _, nb, img = CG.stencil(gt, CE.OFF27, "cpu")
    nc = np.asarray(gt.ncell)
    for o, d in enumerate(CE.OFF27):
        full = cfull + np.asarray(d)
        want_img = np.where(full >= nc, 1, np.where(full < 0, -1, 0))
        want = np.asarray(CM._scid(gj, jnp.asarray(full - want_img * nc)))
        np.testing.assert_array_equal(nb[:, o].numpy(), want)
        np.testing.assert_array_equal(img[:, o].numpy(), want_img)
    g = np.random.default_rng(9)
    p = ((pos + 0.1 * g.standard_normal(pos.shape)) % box).astype(np.float32)
    b = np.asarray(box, np.float32)
    x, y, z, ids, count, over = CG.bin_initial(
        gt, torch.as_tensor(p)[None], torch.as_tensor(b)[None],
        torch.tensor(eam_case.SHIFT))
    jx, jy, jz, jids, jcount, jover = CM.bin_initial(
        gj, jnp.asarray(p), jnp.asarray(b), jnp.asarray(eam_case.SHIFT))
    assert bool(over) == bool(jover) is False
    for a, j in ((x, jx), (y, jy), (z, jz)):
        np.testing.assert_array_equal(a[0].numpy().view(np.uint32),
                                      np.asarray(j).view(np.uint32))
    np.testing.assert_array_equal(ids[0].numpy(), np.asarray(jids))
    np.testing.assert_array_equal(count[0].numpy(), np.asarray(jcount))


def test_rebin_carries_rho_at_stride3(cheb):
    """rebin_axis with the density slab as an extra: slabs, ids, counts
    and the re-sorted rho equal the JAX rebin's, bit for bit."""
    c = eam_case.case(cheb, (500.0, 900.0), seed=7)
    geom, (x, y, z), ids = c["geom"], c["slabs"], c["ids"]
    rho = torch.where(ids >= 0, torch.arange(geom.rows, dtype=torch.float32),
                      0.0)
    gj = eam_case.jax_geom(c)
    tslabs, count, trho = (x, y, z, ids), c["count"], rho
    jslabs = tuple(jnp.asarray(a.numpy()) for a in tslabs)
    jcount, jrho = jnp.asarray(count.numpy()), jnp.asarray(rho.numpy())
    boxes = torch.as_tensor(c["boxes"])
    for axis, frac in ((0, 0.2), (2, 0.7), (1, 0.45)):
        delta = np.float32(frac / geom.ncell[axis])
        tab = CG.geom_tables(geom)[axis]
        tslabs, count, over, (trho,) = CG.rebin_axis(
            geom, tslabs, count, boxes, torch.as_tensor(delta), axis,
            cell_tab=torch.as_tensor(tab), extras=(trho,))
        jslabs, jcount, jover, (jrho,) = CM.rebin_axis(
            gj, jslabs, jcount, jnp.asarray(c["boxes"]), jnp.asarray(delta),
            axis, cell_tab=jnp.asarray(tab), extras=(jrho,))
        assert bool(over) == bool(jover) is False
        for a, b in zip(tslabs, jslabs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
        np.testing.assert_array_equal(trho.numpy(), np.asarray(jrho))
    # every atom's rho still travels with its id
    idn = tslabs[3].numpy()
    start = {int(i): float(v) for i, v in zip(ids[0].numpy(),
                                              rho[0].numpy()) if i >= 0}
    for i, v in zip(idn[0], trho[0].numpy()):
        if i >= 0:
            assert start[int(i)] == v
