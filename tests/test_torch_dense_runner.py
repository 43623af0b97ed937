"""The dense engine through the port's entry points against the JAX
runner's dense chunk, on the CPU.

- ``runner.setup_run(engine="dense")``: the ghost map, its shell and
  capacity, the cells and the list capacity equal the JAX set-up's, pe and
  virial (from neighbour lists, as the JAX set-up takes them) within rtol
  1e-5; then one chunk of ``run_sampling`` (the JAX runner's chunk is
  ``make_dense_run_fn`` with exchange: 2 records x 2 sweeps on a 2x2
  (P, T) grid, 4 passes and a volume trial a sweep): keys, counters, diag,
  hist, xacc and record decisions equal, pe and virial within rtol 1e-5,
  vol within 1e-6, frames within 1e-5 of the box edge, the ghost map's
  parents, slots and counts equal; a decision could part only at an f32
  margin (energies are summed in another order), and on this seed none
  does;
- the port's own restart: that chunk checkpointed, then a second chunk,
  equals bit for bit the same second chunk from ``restore_setup`` on a
  fresh set-up (states, keys, ghost map, records, frames, hist, xacc);
- a JAX dense checkpoint (no ghost map) resumes as the JAX runner
  resumes it, with a warning: the next chunk's hist, xacc and decisions
  equal, energies and frames within the limits above;
- ``remcmc --engine dense`` and its ``--restart``, and
  ``melting_pipeline(engine="dense")``;
- a record block's state-free draws made a sweep at a time (the span
  ``checkerboard.draw_spans`` gives when a block's draws pass
  DRAW_BYTES) give the chunk of one span a block bit for bit, on the
  dense and the gather engine;
- the JAX runner's refusals, before any work (without a GPU the default
  device would raise otherwise): EAM and ``phmc > 0`` the same
  ValueError as the JAX runner, more than one process (the process count
  patched) its NotImplementedError.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from neuralmelting_tpu import runner as JR
from neuralmelting_tpu.config import RunConfig as JConfig
from neuralmelting_tpu_torch import pipeline as TP
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.cli import remcmc
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.io import thermo
from neuralmelting_tpu_torch.ops import ghosts as G
from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler import dense as DS
from neuralmelting_tpu_torch.sampler.state import FIELDS

_KW = dict(name="d", element="LJ", ncells=(4, 4, 4), npress=2, ntemp=2,
           press=(1.0, 1.3), temp=(0.8, 0.84), nsmpl=2, mod=2, ncut=0,
           seed=3)
CFG = RunConfig(**_KW)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hold(t, j):
    """A port chunk against a JAX chunk (both (setup, recs, frames, hist,
    xacc, diag))."""
    assert int(j[5]) == 0 and t[5] == 0
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]))
    for f in ("sweep", "temp", "press", "acc_pos", "acc_vol", "dpos",
              "dvol"):
        np.testing.assert_array_equal(getattr(t[1], f).numpy(),
                                      np.asarray(getattr(j[1], f)), f)
    for f, tol in (("pe", 1e-5), ("virial", 1e-5), ("vol", 1e-6)):
        np.testing.assert_allclose(getattr(t[1], f).numpy(),
                                   np.asarray(getattr(j[1], f)), rtol=tol,
                                   err_msg=f)
    np.testing.assert_allclose(t[2][0].numpy(), np.asarray(j[2][0]), rtol=0,
                               atol=1e-5 * float(np.max(np.asarray(j[2][1]))))
    ts, js = t[0].states, j[0].states
    for f in ("nap", "ntp", "nav", "ntv", "sweep"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    np.testing.assert_array_equal(ts.key.numpy(),
                                  np.asarray(jax.random.key_data(js.key)))
    for f in ("parent_ext", "slots_of", "nghost", "overflow"):
        np.testing.assert_array_equal(getattr(t[0].gms, f).numpy(),
                                      np.asarray(getattr(j[0].gms, f)), f)


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """The JAX runner's dense set-up and chunk (its checkpoint written),
    and the port's (its checkpoint written) from the same config."""
    d = tmp_path_factory.mktemp("dense")
    js = JR.setup_run(JConfig(**_KW), engine="dense")
    j_setup = {f: np.asarray(getattr(js.gms, f)) for f in G.FIELDS}
    j_setup.update(pe=np.asarray(js.states.pe),
                   virial=np.asarray(js.states.virial))
    jpath, tpath = str(d / "j.npz"), str(d / "t.npz")
    jc = JR.run_sampling(js, write_files=False, checkpoint_path=jpath)
    ts = runner.setup_run(CFG, engine="dense", device="cpu")
    t_setup = ts
    DS.reset_counts()
    tc = runner.run_sampling(ts, write_files=False, checkpoint_path=tpath)
    return dict(j_setup=j_setup, js=js, jc=jc, jpath=jpath, t_setup=t_setup,
                tc=tc, counts=dict(DS.COUNTS), tpath=tpath)


def test_setup_and_chunk(chunks):
    ts, j = chunks["t_setup"], chunks["j_setup"]
    assert ts.engine == "dense" and ts.nls is None
    assert (ts.shell, ts.gcap, ts.cap) == (chunks["js"].shell,
                                           chunks["js"].gcap,
                                           chunks["js"].cap)
    assert ts.cellcfg.ncell == chunks["js"].cellcfg.ncell
    for f in G.FIELDS:
        np.testing.assert_array_equal(getattr(ts.gms, f).numpy(), j[f], f)
    for f in ("pe", "virial"):
        np.testing.assert_allclose(getattr(ts.states, f).numpy(), j[f],
                                   rtol=1e-5)
    _hold(chunks["tc"], chunks["jc"])
    counts = chunks["counts"]
    assert counts["sweeps"] == 4 and counts["passes"] == 16
    assert counts["syncs"] == 20 and counts["rebuilds"] > 0
    assert int(chunks["tc"][4].sum()) > 0


def test_exact_resume(chunks):
    a = runner.run_sampling(chunks["tc"][0], write_files=False)
    with_map = runner.restore_setup(
        runner.setup_run(CFG, engine="dense", device="cpu"), chunks["tpath"])
    b = runner.run_sampling(with_map, write_files=False)
    sa, sb = a[0].states, b[0].states
    for f in FIELDS:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert torch.equal(sa.key, sb.key)
    for f in G.FIELDS:
        assert torch.equal(getattr(a[0].gms, f), getattr(b[0].gms, f)), f
    for f in ("pe", "virial", "vol", "acc_pos", "acc_vol", "dpos"):
        assert torch.equal(getattr(a[1], f), getattr(b[1], f)), f
    assert torch.equal(a[2][0], b[2][0]) and torch.equal(a[3], b[3])
    assert torch.equal(a[4], b[4]) and a[5] == b[5] == 0


def test_jax_checkpoint_resumes_as_in_jax(chunks):
    js = JR.restore_setup(chunks["jc"][0], chunks["jpath"])
    jc = JR.run_sampling(js, write_files=False)
    with pytest.warns(RuntimeWarning, match="holds no ghost map"):
        ts = runner.restore_setup(
            runner.setup_run(CFG, engine="dense", device="cpu"),
            chunks["jpath"])
    _hold(runner.run_sampling(ts, write_files=False), jc)


def test_remcmc_and_pipeline(tmp_path, capsys):
    argv = ["-n", "dn", "-e", "LJ", "-ss", "4", "-pn", "1", "-tn", "2",
            "-tr", "0.7", "0.9", "-sn", "2", "-sm", "1", "-sd", "5",
            "--engine", "dense", "--device", "cpu"]
    out, out2 = str(tmp_path / "o"), str(tmp_path / "o2")
    DS.reset_counts()
    remcmc.main(argv + ["-o", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["diag"] == 0 and DS.COUNTS["sweeps"] == 2
    remcmc.main(argv + ["-o", out2, "--restart",
                        os.path.join(out, "dn.lj.ckpt.npz")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["diag"] == 0
    _, rows = thermo.read(os.path.join(out2, "dn.lj.fcc.4x4x4.00.00.thrm"))
    assert rows["sweep"].tolist() == [3, 4]
    cfg = RunConfig(name="dp", element="LJ", ncells=(4, 4, 4), npress=1,
                    ntemp=4, press=(1.0,), temp=(0.5, 0.8, 1.1, 1.4),
                    nsmpl=3, mod=1, ncut=1, seed=2)
    DS.reset_counts()
    res = TP.melting_pipeline(cfg, nbins=16, model="mlp", epochs=20, band=1,
                              engine="dense", device="cpu")
    assert DS.COUNTS["sweeps"] == 3 and res.diag == 0
    assert np.isfinite(res.tm).all() and res.moves_tried > 0


@pytest.mark.parametrize("engine", ["dense", "gather"])
def test_draw_spans_keep_the_bits(chunks, monkeypatch, engine):
    assert CB.draw_spans(5, 1) == [5]
    a = chunks["tc"] if engine == "dense" else runner.run_sampling(
        runner.setup_run(CFG, engine=engine, device="cpu"),
        write_files=False)
    monkeypatch.setattr(CB, "DRAW_BYTES", 1)
    assert CB.draw_spans(5, 1) == [1] * 5
    b = runner.run_sampling(runner.setup_run(CFG, engine=engine,
                                             device="cpu"),
                            write_files=False)
    for f in FIELDS:
        assert torch.equal(getattr(a[0].states, f),
                           getattr(b[0].states, f)), f
    for f in ("pe", "virial", "vol", "acc_pos", "acc_vol", "dpos"):
        assert torch.equal(getattr(a[1], f), getattr(b[1], f)), f
    assert torch.equal(a[2][0], b[2][0]) and torch.equal(a[3], b[3])
    assert torch.equal(a[4], b[4]) and a[5] == b[5] == 0


def test_refusals(monkeypatch):
    # phmc: the JAX runner raises first, before any work
    kw = dict(_KW, phmc=0.05)
    with pytest.raises(ValueError, match="not offered on the 'dense'") as j:
        JR.setup_run(JConfig(**kw), engine="dense")
    # before any work on the port's side: the default device (the card,
    # absent here) is not reached
    with pytest.raises(ValueError) as t:
        runner.setup_run(RunConfig(**kw), engine="dense")
    assert str(t.value) == str(j.value)
    # EAM: the JAX runner's message (runner.py:136, reached there after
    # its set-up work)
    with pytest.raises(ValueError) as t:
        runner.setup_run(RunConfig(**dict(_KW, element="AL")),
                         engine="dense")
    assert str(t.value) == "dense engine supports pair potentials only"
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        runner.setup_run(CFG, engine="dense")
