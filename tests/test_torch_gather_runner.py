"""The gather engine through the port's entry points, on the CPU.

- ``runner.setup_run`` runs gather by default (as the JAX runner does);
  a chunk checkpointed, then a second chunk, equals bit for bit the same
  second chunk run from ``restore_setup`` on a fresh setup (states, keys,
  records, frames, hist, xacc); the run function stays with the setup;
- the JAX package's ``io.checkpoint.load`` reads that checkpoint with the
  replicas' live keys; a JAX gather checkpoint (no list extras) resumes
  in the port as the JAX runner resumes it: the next chunk's hist and
  xacc equal, records within the tolerances of
  tests/test_torch_gather_engine.py;
- EAM runs on gather, and gather refuses a box too small for its
  stride-2 cells at 2 rc, as the JAX runner does; ``exchange=False`` on
  gather raises, as in the JAX runner; HMC on cellmc raises;
- ``melting_pipeline`` and ``remcmc`` with no engine named run gather
  (tiny configs), remcmc with ``--phmc`` trying HMC moves, then resuming
  with ``--restart``; without CUDA the default device raises.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from neuralmelting_tpu import runner as JR
from neuralmelting_tpu.config import RunConfig as JConfig
from neuralmelting_tpu.io import checkpoint as JCK
from neuralmelting_tpu_torch import pipeline as TP
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.cli import remcmc
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.io import thermo
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.parallel import ensemble as ENS
from neuralmelting_tpu_torch.sampler.state import FIELDS

_KW = dict(name="gr", element="LJ", ncells=(3, 3, 3), npress=2, ntemp=2,
           press=(1.0, 1.3), temp=(0.8, 0.84), nsmpl=2, mod=2, ncut=0,
           seed=4)
CFG = RunConfig(**_KW)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_chunk(a, b):
    sa, sb = a[0].states, b[0].states
    for f in FIELDS:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert torch.equal(sa.key, sb.key)
    for f in ("pe", "virial", "vol", "acc_pos", "dpos"):
        assert torch.equal(getattr(a[1], f), getattr(b[1], f)), f
    assert torch.equal(a[2][0], b[2][0]) and torch.equal(a[3], b[3])
    assert torch.equal(a[4], b[4]) and a[5] == b[5] == 0


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("g") / "g.ckpt.npz")
    s = runner.setup_run(CFG, device="cpu")
    assert s.engine == "gather" and s.nls is not None
    s = runner.run_sampling(s, checkpoint_path=path, write_files=False)[0]
    return s, path


def test_exact_resume(chunked):
    s, path = chunked
    a = runner.run_sampling(s, write_files=False)
    b = runner.run_sampling(runner.restore_setup(
        runner.setup_run(CFG, device="cpu"), path), write_files=False)
    _same_chunk(a, b)



def test_run_functions_go_with_the_setup(chunked):
    """A chunk's run function (and on the card its CUDA graphs) lives on
    the setup: the next chunk and every setup replaced from it reuse it,
    and a new setup starts with none."""
    s, _ = chunked
    fn, = s.run_fns.values()
    assert runner._gather_run_fn(s, CFG.nsmpl, True) is fn
    assert dataclasses.replace(s, slot_of=s.slot_of).run_fns is s.run_fns
    assert runner.setup_run(CFG, device="cpu").run_fns == {}


def test_jax_reads_the_live_keys(chunked):
    s, path = chunked
    states, slot_of, cfg_json, extra = JCK.load(path)
    keys = np.asarray(jax.random.key_data(states.key))
    np.testing.assert_array_equal(keys, s.states.key.numpy())
    fresh = runner.setup_run(CFG, device="cpu").states.key.numpy()
    assert not np.array_equal(keys, fresh)     # the keys moved on
    np.testing.assert_array_equal(np.asarray(states.pos), s.states.pos)
    np.testing.assert_array_equal(np.asarray(slot_of), s.slot_of)
    assert {"nl_ref_pos", "nl_ref_box", "nl_capacity"} <= set(extra)


def test_jax_checkpoint_resumes_as_in_jax(tmp_path):
    path = str(tmp_path / "j.npz")
    js = JR.setup_run(JConfig(**_KW))
    js = JR.run_sampling(js, checkpoint_path=path, write_files=False)[0]
    js = JR.restore_setup(js, path)
    _, jrec, jfr, jhist, jx, jdiag = JR.run_sampling(js, write_files=False)
    ts = runner.restore_setup(runner.setup_run(CFG, device="cpu"), path)
    _, trec, tfr, thist, tx, tdiag = runner.run_sampling(ts,
                                                         write_files=False)
    assert int(jdiag) == 0 and tdiag == 0
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for f in ("sweep", "acc_pos", "acc_vol", "dpos", "dvol"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), f)
    for f, tol in (("pe", 1e-5), ("virial", 1e-5), ("vol", 1e-6)):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)), rtol=tol)
    np.testing.assert_allclose(tfr[0].numpy(), np.asarray(jfr[0]), rtol=0,
                               atol=1e-5 * float(np.max(np.asarray(jfr[1]))))


def test_refusals(tmp_path):
    """EAM runs on gather (tests/test_torch_gather_eam_runner.py runs it);
    like the JAX runner, gather refuses a box too small for the stride-2
    checkerboard at 2 rc (the default synthetic table's rc 6 on 4x4x4)."""
    al = RunConfig(element="AL", ncells=(4, 4, 4), npress=1, ntemp=2)
    table = str(tmp_path / "al38.eam.alloy")
    eam_gen.write_setfl(table, rc=3.8)
    s = runner.setup_run(al, setfl=table, device="cpu")
    assert (s.engine, s.style, s.cellcfg.stride) == ("gather", "eam", 2)
    with pytest.raises(ValueError, match="too small"):
        runner.setup_run(al, device="cpu")
    with pytest.raises(ValueError, match="too small"):
        TP.melting_pipeline(al, device="cpu")
    with pytest.raises(ValueError, match="HMC"):
        runner.setup_run(RunConfig(**dict(_KW, phmc=0.1)), engine="cellmc",
                         device="cpu")
    s = runner.setup_run(CFG, device="cpu")
    with pytest.raises(ValueError, match="exchange=False"):
        runner.run_sampling(s, write_files=False, exchange=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            runner.setup_run(CFG)


def test_pipeline_defaults_to_gather():
    cfg = RunConfig(name="gp", element="LJ", ncells=(3, 3, 3), npress=1,
                    ntemp=4, press=(1.0,), temp=(0.5, 0.8, 1.1, 1.4),
                    nsmpl=3, mod=2, ncut=1, seed=2)
    ENS.reset_counts()
    res = TP.melting_pipeline(cfg, nbins=16, model="mlp", epochs=20, band=1,
                              device="cpu")
    assert ENS.COUNTS["sweeps"] == 3 * 2 and ENS.COUNTS["passes"] > 0
    assert res.diag == 0 and np.isfinite(res.tm).all()
    assert res.probs.shape == (1, 4) and res.moves_tried > 0


def test_remcmc_defaults_to_gather_with_hmc_and_restart(tmp_path, capsys):
    argv = ["-n", "h", "-e", "LJ", "-ss", "4", "-pn", "1", "-tn", "2",
            "-tr", "0.7", "0.9", "-sn", "2", "-sm", "2", "-sd", "5",
            "--phmc", "0.05", "-ns", "8", "--device", "cpu"]
    out, out2 = str(tmp_path / "o"), str(tmp_path / "o2")
    ENS.reset_counts()
    remcmc.main(argv + ["-o", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["diag"] == 0 and ENS.COUNTS["sweeps"] == 4
    acc = [thermo.read(os.path.join(out, f"h.lj.fcc.4x4x4.00.0{t}.thrm"))[1]
           ["acc_hmc"] for t in range(2)]
    assert np.max(acc) > 0
    ck = os.path.join(out, "h.lj.ckpt.npz")
    remcmc.main(argv + ["-o", out2, "--restart", ck])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["diag"] == 0
    _, rows2 = thermo.read(os.path.join(out2, "h.lj.fcc.4x4x4.00.00.thrm"))
    assert rows2["sweep"].tolist() == [6, 8]
