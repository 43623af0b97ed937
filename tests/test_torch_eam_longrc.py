"""Long-rc EAM in the port: the synthetic Al table at the published
tables' range (rc 6.3 A, rs 5.1 A), against the JAX package on the CPU
(tests/test_eam_longrc.py and scripts/longrc_run.py's configurations).

- The table, its Chebyshev refit and the geometries: the setfl files are
  the same bytes; the refit's series and domains equal the JAX refit's
  (rtol 1e-6; measured: equal), fit_err < 5e-4; the stride-3 cellmc
  geometry at 5^3 and 7^3 equals the JAX one ((3, 3, 3), kcap 32 and
  72), and the gather checkerboard (stride 2 at the interaction range
  2 rc) gives (2, 2, 2) at 7^3 and refuses 5^3, as in the JAX package.
- The cellmc set-up at 5^3 (B4's plain version) against the brute O(N^2)
  energy of the JAX refit (tests/test_eam_longrc.py's oracle) at rel
  1e-4, abs 0.02; pe/N in (-3.7, -3.0).
- One plain B3 sweep at 5^3, K=32 (27 colour steps, one cell each)
  against the JAX Pallas kernel in interpret mode (~6 s here), as
  tests/test_torch_eam_sweep.py holds it: decisions equal, positions
  within 1e-6, the density slab within 2e-5 absolute (rho ~ 16), the
  tracked dE rtol 1e-4; and that file's self-checks: the slab equals a
  fresh B4 pass, the tracked dE the energy change, atoms stay in their
  cells.
- The default engine (gather) at 7^3, R=2: cells (2, 2, 2), the list
  capacity, pe (rtol 1e-5) and the virial (1e-5 of its summed term
  magnitudes) against the JAX runner's set-up, pe/N within 1e-3 of
  longrc_result.json's -3.3609; the density cache equals ``rho_sums``
  (chip_smoke's eam-longrc runs its chunks).
- ``python -m neuralmelting_tpu_torch.longrc_run --fast --device cpu``:
  the record's geometry, kcap 72, diag 0, pe/N, a nonzero moves/s; the
  JSON only where --out points (longrc_result.json untouched); without a
  GPU the default raises. A slot overflow at K=72 (forced) retries the
  chunk from its start at K=80.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu import runner as JR
from neuralmelting_tpu.config import RunConfig as JConfig
from neuralmelting_tpu.models import eam as JE
from neuralmelting_tpu.models import eam_cheb as JEC
from neuralmelting_tpu.models import eam_gen as JG
from neuralmelting_tpu.ops import cells as JCells
from neuralmelting_tpu.ops.pallas import cellmc as CM
from neuralmelting_tpu.ops.pallas import cellmc_eam as JCE

import test_torch_eam_case as eam_case
from neuralmelting_tpu_torch import longrc_run, runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models import eam as TE
from neuralmelting_tpu_torch.models import eam_cheb as TEC
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.ops import cells as TCells
from neuralmelting_tpu_torch.ops import eam_energy as EE
from neuralmelting_tpu_torch.sampler import cellmc as SC

RC, RS = 6.3, 5.1
PE0_JAX = -3.3609          # longrc_result.json: pe_per_atom_initial
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("longrc")
    jpath, tpath = str(d / "jax.eam.alloy"), str(d / "port.eam.alloy")
    JG.write_setfl(jpath, rc=RC, rs=RS)
    eam_gen.write_setfl(tpath, rc=RC, rs=RS)
    return jpath, tpath


def test_longrc_refit_matches_jax(tables):
    jpath, tpath = tables
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    jch, tch = JEC.from_spline(JE.load(jpath)), TEC.from_spline(
        TE.load(tpath))
    assert float(tch.rc_host) == pytest.approx(RC)
    assert max(tch.fit_err) < 5e-4
    np.testing.assert_allclose(tch.fit_err, jch.fit_err, rtol=1e-6)
    for f in eam_case.FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(tch, f)),
                                   np.asarray(getattr(jch, f)), rtol=1e-6,
                                   atol=0, err_msg=f)


@pytest.mark.parametrize("nc,kcap", [(5, 32), (7, 72)])
def test_longrc_geometry_matches_jax(nc, kcap):
    box = np.array([nc] * 3, float) * 4.05
    n = 4 * nc ** 3
    gj = CM.make_geom(box, RC, n, nsub=1, stride=3)
    gt = CG.make_geom(box, RC, n, nsub=1, stride=3)
    assert (gt.ncell, gt.kcap) == (gj.ncell, gj.kcap) == ((3, 3, 3), kcap)
    if nc == 5:
        for make in (JCells.make_cell_config, TCells.make_cell_config):
            with pytest.raises(ValueError, match="too small"):
                make(box, 2 * RC, stride=2, dpos_cap=0.25)
    else:
        cj = JCells.make_cell_config(box, 2 * RC, stride=2, dpos_cap=0.25)
        ct = TCells.make_cell_config(box, 2 * RC, stride=2, dpos_cap=0.25)
        assert ct.ncell == cj.ncell == (2, 2, 2)
        np.testing.assert_array_equal(ct.active_table, cj.active_table)


def _brute_cheb_pe(ch, pos, box):
    """tests/test_eam_longrc.py's O(N^2) oracle on the JAX refit."""
    pos, box = jnp.asarray(pos), jnp.asarray(box)
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * jnp.round(d / box)
    u = (d ** 2).sum(-1)
    n = pos.shape[0]
    mask = (u < ch.rc * ch.rc) & ~jnp.eye(n, dtype=bool)
    phi = jnp.where(mask, JEC.cheb_eval(ch.c_phi, ch.u_lo, ch.u_hi, u), 0.0)
    fr = jnp.where(mask, JEC.cheb_eval(ch.c_rho, ch.u_lo, ch.u_hi, u), 0.0)
    q = jnp.sqrt(jnp.clip(fr.sum(-1), 0.0, ch.rho_hi))
    femb = JEC.cheb_eval(ch.c_f, ch.q_lo, jnp.sqrt(ch.rho_hi), q)
    return float(0.5 * phi.sum() + femb.sum())


def test_longrc_cellmc_setup_energy(tables):
    """tests/test_eam_longrc.py's slow test, on the port (cellmc, B4's
    plain version)."""
    jpath, tpath = tables
    cfg = RunConfig(name="lrc", element="AL", ncells=(5, 5, 5), npress=1,
                    ntemp=1, press=(1.0,), temp=(300.0,), nsmpl=1, mod=1,
                    seed=3, dpos0=0.1, dvol0=0.004)
    s = runner.setup_run(cfg, setfl=tpath, engine="cellmc", device="cpu")
    assert s.style == "eam" and s.geom.ncell == (3, 3, 3)
    assert s.geom.kcap >= 24
    pe = float(s.states.pe[0])
    ref = _brute_cheb_pe(JEC.from_spline(JE.load(jpath)),
                         s.states.pos[0].numpy(), s.states.box[0].numpy())
    assert pe == pytest.approx(ref, rel=1e-4, abs=0.02)
    assert -3.7 < pe / s.natoms < -3.0


@pytest.fixture(scope="module")
def swept(tables):
    """One ncyc=1 B3 sweep at 5^3 (500 atoms, K=32), R=2 at 300 and
    1200 K, port (plain) and JAX (interpret) from the same slabs."""
    jch, cheb = eam_case.chebs(tables[0])
    temps, r = (300.0, 1200.0), 2
    pos0, box = make_supercell("fcc", 4.05, (5, 5, 5))
    box = np.asarray(box, np.float32)
    g = np.random.default_rng(2)
    pos = np.stack([(pos0 + 0.08 * g.standard_normal(pos0.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    boxes = np.repeat(box[None], r, 0)
    geom = CG.make_geom(box, cheb.rc_host, 500, nsub=1, stride=3)
    assert (geom.ncell, geom.kcap) == ((3, 3, 3), 32)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes),
        torch.tensor(eam_case.SHIFT))
    assert not bool(over)
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = torch.as_tensor(np.concatenate(
        [(1.0 / (eam_case.KB * np.asarray(temps, np.float32)))[:, None],
         np.full((r, 1), 0.15, np.float32), w, boxes], 1))
    scal, series, nser = CE.eam_pack(cheb, "cpu")
    ones = torch.ones(r)
    e0, rho0 = CE.total(geom, (x, y, z), params, scal, series, ones, False)
    seeds = SC.tile_seeds((21, 22), 5, 1, "cpu")
    port = (x.clone(), y.clone(), z.clone(), rho0.clone())
    st = CE.sweep(geom, 1, r, port, count, params, scal, series, seeds)
    sw = JCE.make_eam_sweep_fn(
        CM.make_geom(box, RC, 500, nsub=1, stride=3, kcap=geom.kcap),
        ncyc=1, nser=nser, interpret=True, rt=r)
    jt = eam_case.jt
    (jx, jy, jz, jrho), jst = sw(
        (jt(x), jt(y), jt(z), jt(rho0)), jt(count), jt(params),
        jnp.asarray(scal.numpy()),
        tuple(jnp.asarray(series[i].numpy()) for i in (0, 2, 4)),
        jnp.asarray(seeds.numpy()))
    e1, rho1 = CE.total(geom, port[:3], params, scal, series, ones, False)
    return dict(geom=geom, params=params, port=port, st=st.numpy(),
                jst=np.array(jst).T, e0=e0[:, 0], e1=e1[:, 0], rho1=rho1,
                jslabs=[np.array(a).T for a in (jx, jy, jz, jrho)],
                ok=ids.numpy() >= 0)


def test_longrc_sweep_matches_jax(swept):
    st, jst, ok = swept["st"], swept["jst"], swept["ok"]
    np.testing.assert_array_equal(st[:, 1:3], jst[:, 1:3])   # acc, try
    assert (st[:, 2] == 27).all() and (st[:, 1] > 0).all()
    for a in range(3):
        d = np.abs(swept["port"][a].numpy() - swept["jslabs"][a])[ok]
        assert d.max() <= 1e-6
    rho = swept["port"][3].numpy()
    assert np.abs(rho - swept["jslabs"][3])[ok].max() < 2e-5
    np.testing.assert_allclose(st[:, 0], jst[:, 0], rtol=1e-4, atol=1e-4)


def test_longrc_sweep_self_checks(swept):
    ok, geom, params = swept["ok"], swept["geom"], swept["params"]
    rho = swept["port"][3].numpy()
    assert np.abs(rho - swept["rho1"].numpy())[ok].max() < 2e-5
    assert (rho[~ok] == 0).all()
    tracked = swept["st"][:, 0].astype(np.float64)
    true = (swept["e1"] - swept["e0"]).numpy().astype(np.float64)
    assert (np.abs(tracked - true) < 2e-3 + 1e-4 * np.abs(true)).all()
    tabs = torch.as_tensor(CG.geom_tables(geom))
    for a in range(3):
        lo = tabs[a][None].to(torch.float32) * params[:, 2 + a, None]
        v = swept["port"][a]
        inside = (v >= lo) & (v < lo + params[:, 2 + a, None])
        assert bool(inside[torch.as_tensor(ok)].all())


def test_longrc_default_engine_matches_jax_setup(tables):
    kw = dict(name="lrc", element="AL", ncells=(7, 7, 7), npress=1,
              ntemp=2, press=(1.0,), temp=(400.0, 1800.0), nsmpl=1, mod=1,
              seed=9, dpos0=0.12, dvol0=0.004)
    js = JR.setup_run(JConfig(**kw), setfl=tables[0])
    ts = runner.setup_run(RunConfig(**kw), setfl=tables[1], device="cpu")
    assert ts.engine == "gather" and isinstance(ts.pot, TE.EAMTables)
    assert ts.cellcfg.ncell == js.cellcfg.ncell == (2, 2, 2)
    assert ts.cap == js.cap and ts.aux.shape == (2, 1372)
    assert int(ts.nls.count.max()) <= ts.cap
    np.testing.assert_allclose(ts.states.pe.numpy(),
                               np.asarray(js.states.pe), rtol=1e-5)
    st = ts.states
    gap = np.abs(st.virial.numpy() - np.asarray(js.states.virial))
    assert (gap <= 1e-5 * EE.virial_scale(ts.pot, st.pos, st.box,
                                          ts.nls).numpy()).all(), gap
    assert np.abs(st.pe.numpy() / 1372 - PE0_JAX).max() <= 1e-3
    assert torch.equal(ts.aux, EE.rho_sums(ts.pot, st.pos, st.box, ts.nls))


def test_longrc_run_fast_on_cpu(tmp_path):
    ref = os.path.join(ROOT, "longrc_result.json")
    before = open(ref, "rb").read() if os.path.exists(ref) else None
    out = str(tmp_path / "lrc.json")
    res = longrc_run.main(["--fast", "--device", "cpu", "--out", out])
    assert res["geom_ncell"] == [3, 3, 3] and res["kcap"] == 72
    assert res["natoms"] == 1372 and res["replicas"] == 2
    assert res["diag"] == 0 and res["moves_per_sec"] > 0
    assert res["moves_attempted"] > 0
    assert abs(res["pe_per_atom_initial"] - PE0_JAX) <= 1e-3
    assert -3.7 < res["pe_per_atom_trace"][0] < -3.0
    assert os.path.exists(out)
    after = open(ref, "rb").read() if os.path.exists(ref) else None
    assert after == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            longrc_run.main(["--fast"])


def test_longrc_overflow_retries_at_a_larger_k(tables, monkeypatch):
    """A chunk that reports a slot overflow at K=72 is rerun from its
    start at K=80 (the overflow is forced: at 1 bar a cell rarely gains
    the ~10 atoms it would take in two sweeps)."""
    real, kcaps = SC.make_eam_run_fn, []

    def forced(kb, p2e, geom, **kw):
        run = real(kb, p2e, geom, **kw)

        def wrapped(*args):
            out = list(run(*args))
            if not kcaps:
                out[9] = out[9] | SC.DIAG_SLAB_OVERFLOW
            kcaps.append(geom.kcap)
            return tuple(out)
        return wrapped

    monkeypatch.setattr(SC, "make_eam_run_fn", forced)
    s = runner.setup_run(longrc_run.make_cfg(fast=True), setfl=tables[1],
                         engine="cellmc", device="cpu")
    pre = s.states.pos.clone()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s, recs, _, _, _, diag = runner.run_sampling(s, write_files=False,
                                                     write_traj=False)
    assert kcaps == [72, 80] and s.geom.kcap == 80 and diag == 0
    assert any("kcap=80" in str(w.message) for w in caught)
    ids = s.slabs[3]
    for r in range(ids.shape[0]):
        kept = ids[r][ids[r] >= 0]
        assert torch.equal(torch.sort(kept).values, torch.arange(1372))
    assert not torch.equal(s.states.pos, pre)
    assert np.isfinite(recs.pe.numpy()).all()
