"""The port's EAM engine (sampler/cellmc.py make_eam_run_fn) and the EAM
branch of its runner, on CPU with the plain kernel versions.

* setup_run(element="AL", device="cpu") builds the Chebyshev potential,
  the stride-3 one-mover geometry and the density slab, with exact
  energies; a geometry rebind keeps the slab exact;
* a chunk, with and without exchange, on a small ensemble: diag 0; after
  every B3 sweep of the chunk the carried density slab equals a fresh B4
  pass on the same positions (so the sweeps, volume trials and rebins
  keep it exact, to 5e-5 absolute at rho ~ 13); each record's pe and
  virial equal a fresh B4 pass (identical inputs, identical bits); the
  exchange keeps ``slot_of`` a permutation;
* without a table, the runner writes the synthetic Al table once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models import eam as TE
from neuralmelting_tpu_torch.models import eam_cheb as TEC
from neuralmelting_tpu_torch.models import eam_gen as TG
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler import cellmc as SC


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eam") / "al38.eam.alloy")
    TG.write_setfl(path, rc=3.8)
    return path


def _cfg(**kw):
    base = dict(name="eam", element="AL", ncells=(4, 4, 4), npress=1,
                ntemp=3, press=(1.0,), temp=(500.0, 1100.0, 1700.0),
                nsmpl=2, mod=2, ncut=0, seed=3, dpos0=0.12, dvol0=0.01,
                vol_every=1, rebin_every=1)
    base.update(kw)
    return RunConfig(**base)


def _fresh(setup, slabs, states):
    scal, series, _ = CE.eam_pack(setup.pot, "cpu")
    params = SC.params_of(states, setup.geom, setup.us.kb)
    r = states.temp.shape[0]
    return CE.total(setup.geom, slabs[:3], params, scal, series,
                    torch.ones(r), True)


def test_setup_run_builds_the_eam_ensemble(table):
    setup = runner.setup_run(_cfg(), setfl=table, engine="cellmc",
                             device="cpu")
    g = setup.geom
    assert setup.style == "eam" and isinstance(setup.pot, TEC.EAMCheb)
    assert (g.stride, g.nsub, g.ncell) == (3, 1, (3, 3, 3))
    assert g.kcap == 24 and setup.pot.rc_host == 3.8
    assert len(setup.slabs) == 5 and setup.us.name == "metal"
    st, rho = _fresh(setup, setup.slabs, setup.states)
    np.testing.assert_array_equal(setup.states.pe.numpy(), st[:, 0].numpy())
    np.testing.assert_array_equal(setup.states.virial.numpy(),
                                  st[:, 1].numpy())
    np.testing.assert_array_equal(setup.slabs[4].numpy(), rho.numpy())
    assert (setup.states.pe.numpy() / 256 < -3.0).all()
    # a rebind (here: more slots) rebuilds the density slab exactly
    bigger = runner._rebind_cellmc(
        setup, dataclasses.replace(g, kcap=g.kcap + 8))
    assert bigger.geom.kcap == 32 and len(bigger.slabs) == 5
    st2, rho2 = _fresh(bigger, bigger.slabs, bigger.states)
    np.testing.assert_array_equal(bigger.slabs[4].numpy(), rho2.numpy())
    np.testing.assert_allclose(st2[:, 0].numpy(), st[:, 0].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("exchange", [False, True])
def test_eam_chunk_keeps_density_and_records_exact(table, monkeypatch,
                                                   exchange):
    setup = runner.setup_run(_cfg(), setfl=table, engine="cellmc",
                             device="cpu")
    errs = []
    sweep = CE.sweep

    def checked(geom, ncyc, rt, slabs4, count, params, scal, series, seeds):
        # the slab a sweep receives must be exact: compare its result
        st = sweep(geom, ncyc, rt, slabs4, count, params, scal, series,
                   seeds)
        fresh = CE.total_plain(geom, slabs4[:3], params, scal, series,
                               torch.ones(params.shape[0]), False)[1]
        ok = slabs4[0] < 1e29
        errs.append(float((slabs4[3] - fresh).abs()[ok].max()))
        return st

    monkeypatch.setattr(SC.CE, "sweep", checked)
    nrec, mod = 2, 2
    run = SC.make_eam_run_fn(
        setup.us.kb, setup.us.p2e, setup.geom, mod=mod, nrecords=nrec,
        ncyc=2, nvol=2, exchange=exchange, npress=1, ntemp=3,
        write_traj=True)
    if exchange:
        (states, slabs, count, shift, slot_of, recs, frames, hist, xacc,
         diag, tried) = run(setup.states, setup.slabs, setup.slab_count,
                            setup.shift, setup.slot_of, jrandom.key(4),
                            setup.pot,
                            setup.cell_tabs, setup.t_grid, setup.p_grid,
                            (11, 12))
        assert hist.shape == (nrec, 3) and xacc.shape == (nrec,)
        for row in list(hist) + [slot_of]:
            assert sorted(row.tolist()) == [0, 1, 2]
        np.testing.assert_array_equal(
            states.temp.numpy(), setup.t_grid[slot_of.long()].numpy())
    else:
        (states, slabs, count, shift, recs, frames, diag,
         tried) = run(setup.states, setup.slabs, setup.slab_count,
                      setup.shift, setup.pot, setup.cell_tabs, (11, 12))
    assert int(diag) == 0
    assert len(errs) == nrec * mod and max(errs) < 5e-5, errs
    # the last record's energetics are a fresh pass on the final slabs
    st, rho = _fresh(setup, slabs, states)
    np.testing.assert_allclose(recs.pe[-1].numpy(), st[:, 0].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(recs.virial[-1].numpy(), st[:, 1].numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(slabs[4].numpy(), rho.numpy())
    assert (states.sweep == nrec * mod).all()
    # every cell stays occupied here: one trial per cell and colour step,
    # ncyc=2 cycles of 27 colours, plus nvol=2 volume trials per sweep
    assert bool((count > 0).all())
    assert int(tried) == nrec * mod * 3 * (2 * 27 + 2)
    assert frames[0].shape == (nrec, 3, 256, 3)
    assert torch.isfinite(recs.virial).all()
    ids = slabs[3]
    for r in range(3):
        got = torch.sort(ids[r][ids[r] >= 0]).values
        assert torch.equal(got, torch.arange(256, dtype=torch.int32))


def test_build_potential_writes_the_synthetic_table_once(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(runner.tempfile, "gettempdir", lambda: str(tmp_path))
    cfg = RunConfig(element="AL")
    pot, style = runner.build_potential(cfg)
    path = tmp_path / "nm_synthetic_Al.eam.alloy"
    assert style == "eam" and path.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
    ref = TE.load(TG.write_setfl(str(tmp_path / "ref.eam.alloy")))
    np.testing.assert_array_equal(pot.f_coef, ref.f_coef)
    stamp = path.stat().st_mtime_ns
    runner.build_potential(cfg)
    assert path.stat().st_mtime_ns == stamp
    lj, style = runner.build_potential(RunConfig())
    assert style == "pair" and lj.rc == 2.5
