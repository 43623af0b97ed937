"""Port parity: the port's own config and units, and the EAM models.

* ``config`` and ``units`` are copies the port keeps (it imports nothing of
  the JAX package): the same ``to_json()``, grids, element table and unit
  constants as the JAX modules;
* ``models/eam_gen.py`` writes the JAX package's synthetic Al table byte
  for byte; ``models/eam.py`` parses it into equal arrays and evaluates
  the splines with equal f32 bits;
* ``models/eam_cheb.py`` refits the tables to the JAX series: the same
  lengths, coefficients within relative 1e-6 (the fits see the same f32
  spline samples; only numpy's f64 least squares could round apart), and
  ``cheb_eval`` gives the JAX values within relative 1e-6.
The rc=3.8 table (the repo's EAM bench and validation table) is written
once per module.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu import config as JC
from neuralmelting_tpu import units as JU
from neuralmelting_tpu.models import eam as JE
from neuralmelting_tpu.models import eam_cheb as JEC
from neuralmelting_tpu.models import eam_gen as JG
from neuralmelting_tpu.sampler import cellmc as JSC
from neuralmelting_tpu_torch import config as TC
from neuralmelting_tpu_torch import units as TU
from neuralmelting_tpu_torch.models import eam as TE
from neuralmelting_tpu_torch.models import eam_cheb as TEC
from neuralmelting_tpu_torch.models import eam_gen as TG
from neuralmelting_tpu_torch.ops import cellmc_eam as CE

CONFIGS = [
    dict(),
    dict(name="al", element="AL", ncells=(4, 4, 4), npress=1, ntemp=10,
         press=(1.0,), temp=tuple(np.linspace(400.0, 2200.0, 10)), nsmpl=40,
         mod=20, ncut=15, dpos0=0.1, dvol0=0.01, seed=5),
    dict(name="lj", element="LJ", ncells=(16, 8, 8), npress=3, ntemp=5,
         vol_every=1, rebin_every=3, phmc=0.1, mode="serial"),
]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    d = tmp_path_factory.mktemp("eam")
    jpath, tpath = str(d / "jax.eam.alloy"), str(d / "port.eam.alloy")
    JG.write_setfl(jpath, rc=3.8)
    TG.write_setfl(tpath, rc=3.8)
    return jpath, tpath


@pytest.fixture(scope="module")
def chebs(table):
    jpath, tpath = table
    return JEC.from_spline(JE.load(jpath)), TEC.from_spline(TE.load(tpath))


@pytest.mark.parametrize("kw", CONFIGS, ids=["default", "al", "lj"])
def test_config_matches_jax(kw):
    tcfg, jcfg = TC.RunConfig(**kw), JC.RunConfig(**kw)
    assert tcfg.to_json() == jcfg.to_json()
    assert TC.RunConfig.from_json(jcfg.to_json()) == tcfg
    for a, b in zip(TC.grids(tcfg), JC.grids(jcfg)):
        np.testing.assert_array_equal(a, b)


def test_elements_and_units_match_jax():
    assert sorted(TC.ELEMENTS) == sorted(JC.ELEMENTS)
    for name in TC.ELEMENTS:
        assert (dataclasses.asdict(TC.ELEMENTS[name])
                == dataclasses.asdict(JC.ELEMENTS[name]))
    for name in ("lj", "metal"):
        assert dataclasses.asdict(TU.get(name)) == \
            dataclasses.asdict(JU.get(name))
    with pytest.raises(ValueError):
        TU.get("real")


def test_eam_gen_writes_the_jax_table(table):
    jpath, tpath = table
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def test_setfl_tables_match_jax(table):
    jpath, _ = table
    jd, td = JE.parse_setfl(jpath), TE.parse_setfl(jpath)
    for f in dataclasses.fields(td):
        a, b = getattr(td, f.name), getattr(jd, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    jp, tp = JE.from_setfl(jd), TE.from_setfl(td)
    for f in ("rc", "dr", "drho", "f_coef", "rho_coef", "rphi_coef"):
        a, b = getattr(tp, f), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tp.rc_host == jp.rc_host == 3.8
    assert TE.interaction_range(tp) == JE.interaction_range(jp) == 7.6


def test_spline_eval_matches_jax_bits(table):
    jpath, _ = table
    jp, tp = JE.load(jpath), TE.load(jpath)
    g = np.random.default_rng(1)
    r = g.uniform(0.0, 4.2, 3000)
    rho = g.uniform(0.0, 70.0, 3000)
    for coef, dx, x in (("rphi_coef", "dr", r), ("rho_coef", "dr", r),
                        ("f_coef", "drho", rho)):
        jv, jd = JE.spline_eval(getattr(jp, coef), float(getattr(jp, dx)),
                                jnp.asarray(x))
        tv, td = TE.spline_eval(getattr(tp, coef), getattr(tp, dx), x)
        for t, j in ((tv, np.asarray(jv)), (td, np.asarray(jd))):
            # XLA's CPU flushes denormal intermediates to zero and numpy
            # keeps them: bits are equal except within 1e-30 of zero
            big = np.abs(j) > 1e-30
            np.testing.assert_array_equal(t[big], j[big], err_msg=coef)
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-30,
                                       err_msg=coef)


def test_cheb_refit_matches_jax(chebs):
    jc, tc = chebs
    for f in ("c_phi", "c_phid", "c_rho", "c_rhod", "c_f", "c_fd"):
        a, b = getattr(tc, f), np.asarray(getattr(jc, f))
        assert a.shape == b.shape and a.dtype == np.float32, f
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max(), err_msg=f)
    for f in ("rc", "u_lo", "u_hi", "rho_hi", "q_lo"):
        np.testing.assert_allclose(getattr(tc, f), np.asarray(getattr(jc, f)),
                                   rtol=1e-6, err_msg=f)
    # the production default tol (2e-4 eV) and its achieved errors
    assert max(tc.fit_err) < 2e-4
    np.testing.assert_allclose(tc.fit_err, jc.fit_err, rtol=1e-3)


def test_cheb_eval_matches_jax(chebs):
    jc, tc = chebs
    g = np.random.default_rng(2)
    u = g.uniform(0.5 * float(tc.u_lo), 1.1 * float(tc.u_hi),
                  2000).astype(np.float32)
    for c, a, b in (("c_phi", "u_lo", "u_hi"), ("c_rho", "u_lo", "u_hi")):
        jv = JEC.cheb_eval(getattr(jc, c), getattr(jc, a), getattr(jc, b),
                           jnp.asarray(u))
        tv = TEC.cheb_eval(getattr(tc, c), getattr(tc, a), getattr(tc, b),
                           torch.as_tensor(u))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-6, err_msg=c)


def test_cheb_from_numpy_and_eam_pack_carry_the_jax_series(chebs):
    jc, _ = chebs
    arrays = {f: np.asarray(getattr(jc, f))
              for f in ("rc", "u_lo", "u_hi", "rho_hi", "q_lo", "c_phi",
                        "c_phid", "c_rho", "c_rhod", "c_f", "c_fd")}
    arrays.update(rc_host=jc.rc_host, fit_err=jc.fit_err)
    tc = TEC.cheb_from_numpy(arrays)
    assert tc.rc_host == jc.rc_host and tc.fit_err == jc.fit_err
    jscal, jser, jn = JSC.eam_pack(jc)
    tscal, tser, tn = CE.eam_pack(tc, "cpu")
    assert tn == jn
    np.testing.assert_array_equal(tscal.numpy(), np.asarray(jscal))
    for a, b in zip(tser, jser):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
