"""The port's slice as a whole.

(a) In a fresh interpreter: import every module of neuralmelting_tpu_torch,
    run its CPU pipeline at a tiny LJ config and one EAM chunk, a short
    serial chain with its golden-file writers and a P1 plain variant;
    jax, flax, optax and every module of the JAX package
    neuralmelting_tpu must stay out of sys.modules.
(b) The port's melting_pipeline(engine="cellmc", device="cpu") against
    the JAX package's melting_pipeline(engine="gather") at the same tiny
    config (256 atoms, P*=1, 6 temperatures 0.55-1.45, 10 records of 8
    sweeps). The JAX cellmc engine runs its Pallas kernels in interpret
    mode, too slow here; the gather engine samples the same NPT ensemble.
    vol_every=1 gives both engines a volume trial every sweep (the JAX
    gather engine has no vol_every schedule), so their records relax at
    the same rate. Both runs must report diag 0 and a finite T_m inside
    the grid; the per-slot record means of pe/N and V at the coldest and
    hottest slots must agree within 4 standard errors of the difference
    of means, sqrt(var_jax/n + var_port/n) from each slot's post-burn-in
    records (treated as uncorrelated; the factor 4 absorbs the correlation
    of records 8 sweeps apart); and T_m must agree within one grid spacing.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from neuralmelting_tpu import pipeline as JP
from neuralmelting_tpu import runner as JR
from neuralmelting_tpu.config import RunConfig
from neuralmelting_tpu_torch import pipeline as TP
from neuralmelting_tpu_torch import runner as TR

ROOT = Path(__file__).resolve().parents[1]

_NO_JAX = r"""
import importlib, pkgutil, sys
import neuralmelting_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.pipeline import melting_pipeline
cfg = RunConfig(name="nojax", element="LJ", ncells=(4, 4, 4), npress=1,
                ntemp=2, press=(1.0,), temp=(0.6, 1.4), nsmpl=2, mod=2,
                ncut=0, seed=1)
res = melting_pipeline(cfg, nbins=16, model="mlp", epochs=3, band=1,
                       device="cpu")
assert res.diag == 0 and res.probs.shape == (1, 2), res
import os, tempfile
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.models import eam_gen
table = os.path.join(tempfile.mkdtemp(), "al38.eam.alloy")
eam_gen.write_setfl(table, rc=3.8)
al = RunConfig(name="nojax", element="AL", ncells=(4, 4, 4), npress=1,
               ntemp=1, press=(1.0,), temp=(900.0,), nsmpl=1, mod=1,
               ncut=0, seed=1)
setup = runner.setup_run(al, setfl=table, device="cpu")
setup, recs, frames, hist, xacc, diag = runner.run_sampling(setup)
assert diag == 0 and setup.style == "eam", diag
from neuralmelting_tpu_torch import golden, probe
state, recs, frames = golden.run_chain("cpu", ncells=2, mod=1, nrecords=1)
golden.write_files(tempfile.mkdtemp(), recs, frames)
assert int(state.ntp) == 0 and recs.sweep.tolist() == [1], recs
a, b = probe.inputs("cpu")
assert probe.probe_plain("pair_div", a, b).isfinite().all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "neuralmelting_tpu"))
print("FOREIGN", bad)
"""


def test_port_imports_and_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout


def test_port_rejects_unported_engines_and_missing_gpu():
    """Unported engines raise naming their ROADMAP item, for LJ and EAM
    alike; the entry points run on the card unless asked for the CPU, so
    without a GPU their defaults raise."""
    cfg = RunConfig(ncells=(4, 4, 4), npress=1, ntemp=2)
    al = RunConfig(element="AL", ncells=(4, 4, 4), npress=1, ntemp=2)
    for c in (cfg, al):
        for engine in ("gather", "dense", "serial"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                TR.setup_run(c, engine=engine)
    import torch
    if not torch.cuda.is_available():
        for c in (cfg, al):
            with pytest.raises(RuntimeError, match="CUDA"):
                TR.setup_run(c)
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.melting_pipeline(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.melting_pipeline(cfg, device="cuda")


@pytest.fixture(scope="module")
def both(request):
    cap = {}

    def spy(mod, tag):
        orig = mod.run_sampling

        def run(*a, **k):
            out = orig(*a, **k)
            cap[tag] = out
            return out
        return orig, run

    cfg = RunConfig(name="slice", element="LJ", ncells=(4, 4, 4), npress=1,
                    ntemp=6, press=(1.0,),
                    temp=tuple(np.linspace(0.55, 1.45, 6)), nsmpl=10, mod=8,
                    ncut=2, seed=7, dpos0=0.1, dvol0=0.01, vol_every=1)
    kw = dict(nbins=48, model="mlp", epochs=400, band=1)
    mp = pytest.MonkeyPatch()
    for mod, tag in ((JR, "jax"), (TR, "port")):
        mp.setattr(mod, "run_sampling", spy(mod, tag)[1])
    try:
        rj = JP.melting_pipeline(cfg, engine="gather", **kw)
        rt = TP.melting_pipeline(cfg, engine="cellmc", device="cpu", **kw)
    finally:
        mp.undo()
    return cfg, rj, rt, cap


def test_slice_runs_clean(both):
    cfg, rj, rt, _ = both
    for res in (rj, rt):
        assert res.diag == 0
        assert np.isfinite(res.tm).all()
        assert cfg.temp[0] <= res.tm[0] <= cfg.temp[-1]
    assert rt.g_slot.shape == (6, 48) and np.isfinite(rt.g_slot).all()
    assert rt.probs.shape == (1, 6) and rt.moves_tried > 0


def _slot_records(out, natoms, burn):
    _, recs, _, hist, _, _ = out
    hist = np.asarray(hist)
    pe = JP.slot_order_features(np.asarray(recs.pe) / natoms, hist)[burn:]
    vol = JP.slot_order_features(np.asarray(recs.vol), hist)[burn:]
    return pe, vol


@pytest.mark.parametrize("slot", [0, 5])
def test_slice_record_means_match_jax(both, slot):
    cfg, _, _, cap = both
    j = _slot_records(cap["jax"], 256, cfg.ncut)
    t = _slot_records(cap["port"], 256, cfg.ncut)
    for name, a, b in (("pe/N", j[0][:, slot], t[0][:, slot]),
                       ("V", j[1][:, slot], t[1][:, slot])):
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        assert abs(a.mean() - b.mean()) < 4.0 * se, \
            (name, slot, a.mean(), b.mean(), se)


def test_slice_tm_matches_jax(both):
    cfg, rj, rt, _ = both
    spacing = (cfg.temp[-1] - cfg.temp[0]) / (len(cfg.temp) - 1)
    assert abs(float(rt.tm[0]) - float(rj.tm[0])) < spacing, \
        (rt.tm, rj.tm)


def test_cooling_leg_reuses_the_heating_classifier(both):
    """init="liquid" pre-melts every replica (runner.liquid_start) and
    applies the heating leg's classifier; without one it refuses."""
    _, _, rt, _ = both
    cfg = RunConfig(name="cool", element="LJ", ncells=(4, 4, 4), npress=1,
                    ntemp=2, press=(1.0,), temp=(0.55, 1.45), nsmpl=2,
                    mod=2, ncut=0, seed=3)
    with pytest.raises(ValueError, match="classify_with"):
        TP.melting_pipeline(cfg, init="liquid", device="cpu")
    res = TP.melting_pipeline(cfg, nbins=48, init="liquid",
                              classify_with=rt, device="cpu")
    assert res.diag == 0 and res.losses.shape == (0,)
    assert res.classifier is rt.classifier
    assert res.probs.shape == (1, 2) and np.isfinite(res.probs).all()
    # every replica ran 5 melt records of 2 sweeps before its 2 records
    assert int(res.records.sweep[-1, 0]) == 5 * 2 + 2 * 2
    np.testing.assert_allclose(res.records.temp[-1].sort().values.numpy(),
                               cfg.temp, rtol=1e-6)
