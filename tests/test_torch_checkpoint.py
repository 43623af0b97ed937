"""Port parity: checkpoints (neuralmelting_tpu_torch.io.checkpoint) and
``runner.restore_setup``.

- A port checkpoint loads in the JAX package's ``checkpoint.load``: every
  field with the JAX dtype, ``slot_of``, the config, and ``key_data``
  equal to the keys the JAX ``ensemble_init`` gives for the config's seed.
- A JAX checkpoint loads in the port's ``load`` (the counterpart of
  tests/test_cli_pipeline.py::test_checkpoint_roundtrip).
- Exact resume, on the CPU: a chunk, a checkpoint, a fresh set-up restored
  from it and a second chunk give the second chunk of an uninterrupted run
  bit for bit (records, frames, slot history), LJ and EAM on the cellmc
  engine and EAM on the gather engine. A cellmc checkpoint carries the
  slabs (coordinates in the shifted frame and the atom of every slot) and
  the grid shift, and its host draws go on from the key chain of the
  config's seed at the sweep counter; a gather checkpoint the
  positions and boxes its lists were built from, and the density cache is
  rebuilt from them (the chunk ended on a record, which rebuilt it from
  scratch).
- ``remcmc --restart`` rebuilds from the restored positions: the first
  resumed record's pe/N is < -4.0 at 4x4x4 (tests/test_cli_pipeline.py's
  restart test), from a port checkpoint and from one without the port's
  extras (re-binned at shift 0, with a warning).
- A checkpoint of an earlier port version, with a ``torch.Generator``
  state taken on the card, resumes on the CPU with one warning and the
  draws of a clean checkpoint.
"""

import dataclasses
import glob
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu.io import checkpoint as JC
from neuralmelting_tpu.models.lattice import make_supercell as jax_supercell
from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.sampler.state import ensemble_init as jax_ensemble
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.cli import remcmc
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.io import checkpoint as ckpt
from neuralmelting_tpu_torch.io import thermo
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.sampler.state import FIELDS

INT_FIELDS = ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")

LJ_CFG = RunConfig(name="ck", element="LJ", ncells=(4, 4, 4), npress=1,
                   ntemp=2, press=(1.0,), temp=(0.7, 1.3), nsmpl=2, mod=2,
                   seed=9, dpos0=0.1, dvol0=0.01, vol_every=1,
                   rebin_every=1)
AL_CFG = RunConfig(name="ck", element="AL", ncells=(4, 4, 4), npress=1,
                   ntemp=2, press=(1.0,), temp=(900.0, 1500.0), nsmpl=2,
                   mod=2, seed=5, dpos0=0.1, dvol0=0.01, vol_every=1,
                   rebin_every=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors run fastest on one thread; the tests share the machine
    with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eam") / "al38.eam.alloy")
    eam_gen.write_setfl(path, rc=3.8)
    return path


def _setup(cfg, table, engine="cellmc"):
    return runner.setup_run(cfg, setfl=table if cfg.element == "AL"
                            else None, engine=engine, device="cpu")


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    """An LJ ensemble after one chunk, checkpointed."""
    setup = _setup(LJ_CFG, None)
    path = str(tmp_path_factory.mktemp("ck") / "lj.ckpt.npz")
    setup = runner.run_sampling(setup, checkpoint_path=path,
                                write_traj=False)[0]
    return setup, path


def test_port_checkpoint_loads_in_jax(sampled):
    setup, path = sampled
    states, slot_of, cfg_json, extra = JC.load(path)
    for f in FIELDS:
        got = np.asarray(getattr(states, f))
        want = getattr(setup.states, f).numpy()
        assert got.dtype == (np.int32 if f in INT_FIELDS else np.float32), f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(np.asarray(slot_of), setup.slot_of.numpy())
    assert cfg_json == LJ_CFG.to_json()
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(LJ_CFG.seed), jnp.arange(2))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(states.key)),
                                  np.asarray(jax.random.key_data(keys)))
    assert {"geom", "shift", "slab_xyz", "slab_ids"} <= set(extra)
    assert not {"gen_state", "gen_device"} & set(extra)


def test_jax_checkpoint_loads_in_port(tmp_path):
    pos, box = jax_supercell("fcc", 1.6, 2)
    states = jax_ensemble(JLJ.create(), pos, box, 9, jnp.array([0.5, 1.0]),
                          jnp.array([1.0, 2.0]), 0.1, 0.01, 0.005)
    path = str(tmp_path / "j.npz")
    JC.save(path, states, jnp.array([1, 0], jnp.int32),
            config_json='{"x": 1}', extra={"note": np.arange(3)})
    got, slot_of, cfg_json, extra = ckpt.load(path)
    for f in FIELDS:
        t = getattr(got, f)
        assert t.dtype == (torch.int32 if f in INT_FIELDS
                           else torch.float32), f
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(states, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.key.numpy(),
                                  np.asarray(jax.random.key_data(states.key)))
    assert slot_of.tolist() == [1, 0]
    assert json.loads(cfg_json)["x"] == 1
    np.testing.assert_array_equal(extra["note"], np.arange(3))


@pytest.mark.parametrize("cfg,engine", [(LJ_CFG, "cellmc"),
                                        (AL_CFG, "cellmc"),
                                        (AL_CFG, "gather")],
                         ids=["LJ", "AL", "AL_gather"])
def test_exact_resume(tmp_path, table, cfg, engine):
    path = str(tmp_path / "c.npz")
    a = _setup(cfg, table, engine)
    a = runner.run_sampling(a, checkpoint_path=path)[0]
    a, ra, fa, ha, xa, da = runner.run_sampling(a)
    b = runner.restore_setup(_setup(cfg, table, engine), path)
    b, rb, fb, hb, xb, db = runner.run_sampling(b)
    assert da == db == 0
    for f in dataclasses.fields(ra):
        assert torch.equal(getattr(ra, f.name), getattr(rb, f.name)), f.name
    assert torch.equal(fa[0], fb[0]) and torch.equal(fa[1], fb[1])
    assert torch.equal(ha, hb) and torch.equal(xa, xb)
    for f in FIELDS:
        assert torch.equal(getattr(a.states, f), getattr(b.states, f)), f
    if engine == "cellmc":
        assert torch.equal(a.shift, b.shift)
    else:
        # the lists and the density cache rebuilt at restore are the ones
        # the uninterrupted run carried
        assert torch.equal(a.nls.idx, b.nls.idx)
        assert torch.equal(a.aux, b.aux) and a.aux.shape == (2, 256)


def _resume_pe(tmp_path, capsys, strip):
    out = str(tmp_path / "o1")
    argv = ["-n", "r", "-e", "LJ", "-ss", "4", "-pn", "1", "-tn", "4",
            "-tr", "0.5", "1.4", "-sn", "4", "-sm", "3", "-sd", "9",
            "--device", "cpu", "--engine", "cellmc"]
    remcmc.main(argv + ["-o", out])
    ck = os.path.join(out, "r.lj.ckpt.npz")
    if strip:
        # only what the JAX package writes: no slabs or shift
        with np.load(ck) as z:
            keep = {k: z[k] for k in z.files if not k.startswith("x_")}
        ck = str(tmp_path / "bare.npz")
        np.savez(ck, **keep)
    out2 = str(tmp_path / "o2")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        remcmc.main(argv + ["-o", out2, "--restart", ck])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    thrm = sorted(glob.glob(os.path.join(out2, "r.lj.fcc.4x4x4.*.thrm")))
    return summary, thrm, [str(w.message) for w in caught]


@pytest.mark.parametrize("strip", [False, True],
                         ids=["port", "without_extras"])
def test_restart_rebuilds_from_restored_positions(tmp_path, capsys, strip):
    summary, thrm, msgs = _resume_pe(tmp_path, capsys, strip)
    assert summary["diag"] == 0 and len(thrm) == 4
    _, d = thermo.read(thrm[0])
    assert np.isfinite(d["pe"]).all()
    # near the checkpointed equilibrium, not the fresh lattice's value
    assert d["pe"][0] / 256 < -4.0
    rebinned = any("re-binned at grid shift 0" in m for m in msgs)
    assert rebinned == strip


def test_restore_warns_and_reseeds_on_generator_device(sampled, tmp_path):
    """A checkpoint of an earlier port version carries the state of a
    torch.Generator that ran on the card: it resumes on the CPU, warns
    once that the state is ignored, and the resumed chunk draws from the
    key chain of the config's seed exactly as from a clean checkpoint."""
    setup, path = sampled
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["x_gen_state"] = np.zeros(16, np.uint8)
    arrays["x_gen_device"] = np.str_("cuda")
    arrays["config"] = np.frombuffer(b'{"seed": 1}', np.uint8)
    moved = str(tmp_path / "moved.npz")
    np.savez(moved, **arrays)
    with pytest.warns(UserWarning) as rec:
        got = runner.restore_setup(_setup(LJ_CFG, None), moved)
    msgs = [str(w.message) for w in rec]
    assert any("different RunConfig" in m for m in msgs)
    assert sum("torch.Generator" in m for m in msgs) == 1
    # the slabs still come back as they were
    assert torch.equal(got.slabs[3], setup.slabs[3])
    assert torch.equal(got.shift, setup.shift)
    clean = runner.restore_setup(_setup(LJ_CFG, None), path)
    ra = runner.run_sampling(got, nrecords=1, write_traj=False)[1]
    rb = runner.run_sampling(clean, nrecords=1, write_traj=False)[1]
    for f in dataclasses.fields(ra):
        assert torch.equal(getattr(ra, f.name), getattr(rb, f.name)), f.name


def test_restore_refuses_another_ensemble(sampled):
    _, path = sampled
    other = dataclasses.replace(LJ_CFG, ntemp=3, temp=(0.7, 1.0, 1.3))
    with pytest.raises(ValueError, match="does not fit"):
        runner.restore_setup(_setup(other, None), path)


def test_restore_setup_raises_without_cuda(sampled):
    _, path = sampled
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        remcmc.main(["-ss", "4", "-pn", "1", "-tn", "2", "--engine",
                     "cellmc", "--restart", path,
                     "-o", path + ".out"])
