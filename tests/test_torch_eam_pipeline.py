"""The port's EAM slice as a whole.

The port's melting_pipeline(element="AL", setfl=<rc=3.8 table>,
engine="cellmc", device="cpu") against the JAX package's
melting_pipeline(engine="gather") on the same table and tiny config
(256 atoms, P=1 bar, 4 temperatures 400-2800 K, 10 records of 6 sweeps,
vol_every=1 so both engines run a volume trial every sweep). The JAX
cellmc engine runs its Pallas kernels in interpret mode, too slow here;
the gather engine samples the same NPT ensemble of the same tabulated
potential (its splines; the port samples their Chebyshev refit, within
2e-4 eV). The criteria are those of tests/test_torch_pipeline.py: diag 0
and a finite T_m inside the grid for both; per-slot record means of pe/N
and V at the coldest and hottest slots within 4 standard errors of the
difference of means (post-burn-in records treated as uncorrelated; the
factor 4 absorbs the correlation of records 6 sweeps apart); T_m within
one grid spacing; and the same g(r) range and S(q) grid.
"""

import numpy as np
import pytest

from neuralmelting_tpu import pipeline as JP
from neuralmelting_tpu import runner as JR
from neuralmelting_tpu.config import RunConfig
from neuralmelting_tpu.models import eam_gen as JG
from neuralmelting_tpu_torch import pipeline as TP
from neuralmelting_tpu_torch import runner as TR

TEMPS = tuple(float(t) for t in np.linspace(400.0, 2800.0, 4))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eam") / "al38.eam.alloy")
    JG.write_setfl(path, rc=3.8)
    cap = {}

    def spy(mod, tag):
        orig = mod.run_sampling

        def run(*a, **k):
            out = orig(*a, **k)
            cap[tag] = out
            return out
        return run

    cfg = RunConfig(name="eamslice", element="AL", ncells=(4, 4, 4),
                    npress=1, ntemp=4, press=(1.0,), temp=TEMPS, nsmpl=10,
                    mod=6, ncut=2, seed=5, dpos0=0.1, dvol0=0.01,
                    vol_every=1)
    kw = dict(nbins=48, model="mlp", epochs=400, band=1, setfl=path)
    mp = pytest.MonkeyPatch()
    for mod, tag in ((JR, "jax"), (TR, "port")):
        mp.setattr(mod, "run_sampling", spy(mod, tag))
    try:
        rj = JP.melting_pipeline(cfg, engine="gather", **kw)
        rt = TP.melting_pipeline(cfg, engine="cellmc", device="cpu", **kw)
    finally:
        mp.undo()
    return cfg, rj, rt, cap


def test_eam_slice_runs_clean(both):
    cfg, rj, rt, cap = both
    for res in (rj, rt):
        assert res.diag == 0
        assert np.isfinite(res.tm).all()
        assert cfg.temp[0] <= res.tm[0] <= cfg.temp[-1]
    assert rt.g_slot.shape == (4, 48) and np.isfinite(rt.g_slot).all()
    assert rt.probs.shape == (1, 4) and rt.moves_tried > 0
    setup = cap["port"][0]
    assert setup.style == "eam" and setup.geom.stride == 3
    assert len(setup.slabs) == 5                 # x, y, z, ids, rho


def _slot_records(out, burn):
    _, recs, _, hist, _, _ = out
    hist = np.asarray(hist)
    pe = JP.slot_order_features(np.asarray(recs.pe) / 256, hist)[burn:]
    vol = JP.slot_order_features(np.asarray(recs.vol), hist)[burn:]
    return pe, vol


@pytest.mark.parametrize("slot", [0, 3])
def test_eam_slice_record_means_match_jax(both, slot):
    cfg, _, _, cap = both
    j = _slot_records(cap["jax"], cfg.ncut)
    t = _slot_records(cap["port"], cfg.ncut)
    for name, a, b in (("pe/N", j[0][:, slot], t[0][:, slot]),
                       ("V", j[1][:, slot], t[1][:, slot])):
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        assert abs(a.mean() - b.mean()) < 4.0 * se, \
            (name, slot, a.mean(), b.mean(), se)


def test_eam_slice_tm_matches_jax(both):
    cfg, rj, rt, _ = both
    spacing = (cfg.temp[-1] - cfg.temp[0]) / (len(cfg.temp) - 1)
    assert abs(float(rt.tm[0]) - float(rj.tm[0])) < spacing, (rt.tm, rj.tm)


def test_eam_slice_features_match_jax_grids(both):
    """Metal units end to end: the same g(r) range from the initial box
    (Angstrom) and the same S(q) grid."""
    _, rj, rt, _ = both
    assert rt.rmax == pytest.approx(rj.rmax, rel=1e-6)
    np.testing.assert_allclose(rt.q, rj.q, rtol=1e-5)
    np.testing.assert_allclose(rt.press, rj.press)
    np.testing.assert_allclose(rt.temp, rj.temp)
