"""The port's slice as a whole.

(a) In a fresh interpreter: import every module of neuralmelting_tpu_torch,
    run its CPU pipeline at a tiny LJ config, a dense LJ chunk and one
    EAM chunk on each engine, a short
    serial chain with its golden-file writers, a P1 plain variant, a
    sweep of the loop-based CPU reference (refimpl/cpu_ref.py) and the
    long-rc run's configuration (longrc_run.py);
    jax, flax, optax and every module of the JAX package
    neuralmelting_tpu must stay out of sys.modules.
(b) The entry points: unported engines raise naming their ROADMAP item,
    the dense engine refuses EAM as the JAX runner does, EAM runs on the
    gather engine, and without a GPU the defaults raise.

The port's pipeline against the JAX package's at a tiny config is
tests/test_torch_pipeline_slice.py.
"""

import subprocess
import sys
from pathlib import Path

import pytest

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
                       engine="cellmc", device="cpu")
assert res.diag == 0 and res.probs.shape == (1, 2), res
import os, tempfile
from neuralmelting_tpu_torch import runner
setup = runner.setup_run(cfg, engine="dense", device="cpu")
setup, recs, frames, hist, xacc, diag = runner.run_sampling(setup)
assert diag == 0 and setup.gms.pos_ext.shape[0] == 2, diag
from neuralmelting_tpu_torch.models import eam_gen
table = os.path.join(tempfile.mkdtemp(), "al38.eam.alloy")
eam_gen.write_setfl(table, rc=3.8)
al = RunConfig(name="nojax", element="AL", ncells=(4, 4, 4), npress=1,
               ntemp=1, press=(1.0,), temp=(900.0,), nsmpl=1, mod=1,
               ncut=0, seed=1)
setup = runner.setup_run(al, setfl=table, engine="cellmc", device="cpu")
setup, recs, frames, hist, xacc, diag = runner.run_sampling(setup)
assert diag == 0 and setup.style == "eam", diag
setup = runner.setup_run(al, setfl=table, device="cpu")
setup, recs, frames, hist, xacc, diag = runner.run_sampling(setup)
assert diag == 0 and setup.engine == "gather", diag
from neuralmelting_tpu_torch import golden, probe
state, recs, frames = golden.run_chain("cpu", ncells=2, mod=1, nrecords=1)
golden.write_files(tempfile.mkdtemp(), recs, frames)
assert int(state.ntp) == 0 and recs.sweep.tolist() == [1], recs
a, b = probe.inputs("cpu")
assert probe.probe_plain("pair_div", a, b).isfinite().all()
from neuralmelting_tpu_torch import longrc_run
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.refimpl import cpu_ref
pos, box = make_supercell("fcc", 2.0 ** (2 / 3), 2)
ref = cpu_ref.init_ref_state(pos, box, jrandom.key(11), 0.5, 1.0, 0.1, 0.01,
                             0.005)
ref, rrecs = cpu_ref.run_records(ref, 1, 1, 1.0, 1.0, 0.96875, 0.03125)
assert ref.sweep == 1 and rrecs[0][3] + rrecs[0][5] == 32, rrecs
assert longrc_run.make_cfg(fast=True).ncells == (7, 7, 7)
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


def test_port_rejects_unported_engines_and_missing_gpu(tmp_path):
    """Unported engines raise naming their ROADMAP item, for LJ and EAM
    alike; the dense engine refuses EAM with the JAX runner's ValueError;
    EAM runs on the gather engine (on the CPU when asked); the entry
    points run on the card unless asked for the CPU, so without a GPU
    their defaults raise."""
    from neuralmelting_tpu_torch.models import eam_gen
    cfg = RunConfig(ncells=(4, 4, 4), npress=1, ntemp=2)
    al = RunConfig(element="AL", ncells=(4, 4, 4), npress=1, ntemp=2)
    for c in (cfg, al):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TR.setup_run(c, engine="serial")
    with pytest.raises(ValueError, match="pair potentials only"):
        TR.setup_run(al, engine="dense")
    table = str(tmp_path / "al38.eam.alloy")
    eam_gen.write_setfl(table, rc=3.8)
    s = TR.setup_run(al, setfl=table, engine="gather", device="cpu")
    assert s.engine == "gather" and s.style == "eam" and s.aux.shape == (2,
                                                                         256)
    import torch
    if not torch.cuda.is_available():
        for c, kw in ((cfg, {}), (al, {"engine": "cellmc"}),
                      (al, {"setfl": table})):
            with pytest.raises(RuntimeError, match="CUDA"):
                TR.setup_run(c, **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.melting_pipeline(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.melting_pipeline(cfg, device="cuda")
