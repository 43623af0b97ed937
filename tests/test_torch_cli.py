"""Port parity: naming, slot files, metrics and the five CLI stages.

- ``io/naming`` against ``neuralmelting_tpu.io.naming``; the run config a
  command line gives, as JSON text, against the JAX ``config_from_args``
  (the text every .thrm header carries);
- ``runner.write_slot_files``: the same files, byte for byte, as the JAX
  package's for the same numpy records, frames and a permuted ``hist``
  (R=6, N=32, 3 records), with and without frames;
- ``utils.MetricsLogger``: the same event as the JAX logger's;
- the stages at tests/test_cli_pipeline.py's miniature size (4x4x4 LJ, a
  2x6 grid, 8 records of 4 sweeps) with ``--device cpu``: the port's
  remcmc writes the files; the JAX ``cli.parse`` and the port's give
  equal arrays on them; the two ``cli.rdf`` on the same parsed npz give
  g, g_mean, sq and rho within the f32 tolerance ``test_rdf_matches_jax``
  states (one pair count per frame and bin, from r^2 at a bin edge); the
  two ``cli.neural`` on the same
  rdf npz give T_m within one grid spacing (as test_slice_tm_matches_jax:
  the classifiers start from different initial weights); ``post
  --no-plot`` prints one row a pressure;
- ``--engine dense`` under more than one process (the process count
  patched) raises the JAX runner's NotImplementedError, naming its
  ROADMAP item (tests/test_torch_dense_runner.py runs it in one), and
  the multi-process flags one without the others; without CUDA the
  stages' default device raises. The staged runs
  name ``--engine cellmc`` (the default is gather, as in the JAX package,
  for LJ and EAM; tests/test_torch_gather_runner.py and
  tests/test_torch_gather_eam_runner.py run it).
"""

import glob
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neuralmelting_tpu import runner as JR
from neuralmelting_tpu.cli import common as jcommon
from neuralmelting_tpu.cli import neural as jneural
from neuralmelting_tpu.cli import parse as jparse
from neuralmelting_tpu.cli import rdf as jrdf
from neuralmelting_tpu.config import RunConfig as JConfig
from neuralmelting_tpu.io import naming as jnaming
from neuralmelting_tpu.utils.metrics import MetricsLogger as JMetrics
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.cli import common, neural, parse, post, rdf, remcmc
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.io import naming, thermo
from neuralmelting_tpu_torch.sampler.driver import ThermoRecord
from neuralmelting_tpu_torch.utils import MetricsLogger

MINI = ["-n", "t", "-e", "LJ", "-ss", "4", "-pn", "2", "-pr", "1.0", "4.0",
        "-tn", "6", "-tr", "0.4", "1.6", "-sn", "8", "-sm", "4", "-sc", "2",
        "-sd", "3"]
PREFIX = "t.lj.fcc.4x4x4"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors run fastest on one thread; the tests share the machine
    with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ncells", [4, (4, 4, 4), [16, 8, 8], (2, 3, 5)])
@pytest.mark.parametrize("element", ["LJ", "AL"])
@pytest.mark.parametrize("idx", [(0, 0), (3, 17), (12, 5)])
def test_naming_matches_jax(ncells, element, idx):
    args = ("run", element, "fcc", ncells)
    assert naming.run_prefix(*args) == jnaming.run_prefix(*args)
    assert naming.sample_prefix(*args, *idx) == \
        jnaming.sample_prefix(*args, *idx)
    pre = naming.sample_prefix(*args, *idx)
    assert naming.sample_paths("out", pre) == jnaming.sample_paths("out",
                                                                   pre)


@pytest.mark.parametrize("argv", [
    MINI,
    ["-e", "AL", "-ss", "16", "8", "8", "-pn", "3", "-pr", "1", "5000",
     "-tn", "7", "-tr", "600", "1400", "--dpos0", "0.15"],
    ["-ss", "5", "-tn", "5", "-sd", "12"],
])
def test_config_from_args_matches_jax(argv):
    import argparse
    ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    common.add_run_args(ap)
    jcommon.add_run_args(jap)
    cfg = common.config_from_args(ap.parse_args(argv))
    jcfg = jcommon.config_from_args(jap.parse_args(argv))
    assert cfg.to_json() == jcfg.to_json()
    assert RunConfig.from_json(jcfg.to_json()) == \
        RunConfig.from_json(cfg.to_json())


def _slot_inputs(seed, nrec=3, r=6, n=32):
    g = np.random.default_rng(seed)
    rec = {c: (g.standard_normal((nrec, r)) * 10.0 ** g.integers(-2, 3))
           .astype(np.float32) for c in thermo.COLUMNS}
    rec["sweep"] = np.repeat(np.arange(1, nrec + 1, dtype=np.int32)[:, None]
                             * 4, r, axis=1)
    hist = np.stack([g.permutation(r) for _ in range(nrec)]).astype(np.int32)
    pos = g.uniform(0.0, 6.0, (nrec, r, n, 3)).astype(np.float32)
    box = g.uniform(5.5, 6.5, (nrec, r, 3)).astype(np.float32)
    return rec, hist, pos, box


@pytest.mark.parametrize("with_frames", [True, False])
@pytest.mark.parametrize("write_traj", [True, False])
def test_write_slot_files_bytes_match_jax(tmp_path, with_frames, write_traj):
    rec, hist, pos, box = _slot_inputs(7)
    kw = dict(name="slots", element="LJ", ncells=(2, 2, 2), npress=2,
              ntemp=3, press=(1.0, 2.0), temp=tuple(np.linspace(0.5, 1.5, 3)),
              seed=4, write_traj=write_traj)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    runner.write_slot_files(
        RunConfig(**kw), str(port_dir),
        ThermoRecord(**{c: torch.as_tensor(v) for c, v in rec.items()}),
        (torch.as_tensor(pos), torch.as_tensor(box)) if with_frames
        else None, torch.as_tensor(hist), 2, 3, 32)
    JR.write_slot_files(JConfig(**kw), str(jax_dir), SimpleNamespace(**rec),
                        (pos, box) if with_frames else None, hist, 2, 3, 32)
    port = sorted(p.name for p in port_dir.iterdir())
    assert port == sorted(p.name for p in jax_dir.iterdir())
    assert len(port) == 6 * (2 if with_frames and write_traj else 1)
    for name in port:
        assert (port_dir / name).read_bytes() == \
            (jax_dir / name).read_bytes(), name
    # slot (p, t) holds, at each record, the replica that hist puts there
    _, d = thermo.read(str(port_dir / "slots.lj.fcc.2x2x2.01.02.thrm"))
    want = [rec["pe"][k, list(hist[k]).index(5)] for k in range(3)]
    np.testing.assert_allclose(d["pe"], np.asarray(want, np.float64),
                               rtol=1e-9)             # printed with %.9e


def test_metrics_event_matches_jax(tmp_path):
    fields = dict(records=8, replicas=12, natoms=256, seconds=1.234, diag=0,
                  exchange_acc=[1, 0, 2])
    for cls, name in ((MetricsLogger, "port"), (JMetrics, "jax")):
        log = cls(str(tmp_path / name / "m.jsonl"), run_id="t")
        log.log("sampling_chunk", **fields)
        log.log("done")
    got = MetricsLogger.read(str(tmp_path / "port" / "m.jsonl"))
    want = JMetrics.read(str(tmp_path / "jax" / "m.jsonl"))
    for g, w in zip(got, want):
        assert g.pop("t") >= 0 and w.pop("t") >= 0
        assert g == w
    assert len(got) == 2 and got[0]["event"] == "sampling_chunk"
    MetricsLogger(None).log("nothing")          # no path: a no-op


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The port's remcmc at the miniature size, on the CPU."""
    out = str(tmp_path_factory.mktemp("cli"))
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        remcmc.main(MINI + ["-o", out, "--device", "cpu", "--engine",
                            "cellmc"])
    return out, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_remcmc_writes_the_run(staged):
    out, summary = staged
    assert set(summary) == {"outdir", "records", "replicas", "natoms",
                            "diag", "attempted_position_moves",
                            "exchange_acceptances", "seconds"}
    assert summary["diag"] == 0 and summary["replicas"] == 12
    assert summary["natoms"] == 256 and summary["records"] == 8
    assert len(summary["exchange_acceptances"]) == 8
    assert len(glob.glob(os.path.join(out, PREFIX + ".*.thrm"))) == 12
    assert len(glob.glob(os.path.join(out, PREFIX + ".*.traj"))) == 12
    assert os.path.exists(os.path.join(out, "t.lj.ckpt.npz"))
    events = MetricsLogger.read(os.path.join(out, "metrics.jsonl"))
    assert [e["event"] for e in events] == ["sampling_chunk"]
    assert events[0]["records"] == 8 and events[0]["diag"] == 0
    params, _ = thermo.read(os.path.join(out, PREFIX + ".01.05.thrm"))
    assert params["config"] == common.config_from_args(
        _parsed(MINI)).to_json()
    assert params["press_idx"] == "1" and params["temp_idx"] == "5"


def _parsed(argv):
    import argparse
    ap = argparse.ArgumentParser()
    common.add_run_args(ap)
    return ap.parse_args(argv)


@pytest.fixture(scope="module")
def parsed(staged):
    out, _ = staged
    port = os.path.join(out, "port.parsed.npz")
    jax = os.path.join(out, "jax.parsed.npz")
    parse.main(["-i", out, "-n", "t", "-e", "LJ", "-o", port])
    jparse.main(["-i", out, "-n", "t", "-e", "LJ", "-o", jax])
    return port, jax


def test_parse_matches_jax(parsed):
    port, jax = parsed
    with np.load(port) as p, np.load(jax) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        assert p["positions"].shape == (2, 6, 8, 256, 3)
        assert p["pe"].shape == (2, 6, 8)
        np.testing.assert_allclose(p["temp"][:, :, 0],
                                   np.tile(np.linspace(0.4, 1.6, 6), (2, 1)),
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def features(parsed):
    port_in, _ = parsed
    port = port_in.replace(".parsed.npz", ".port.rdf.npz")
    jax = port_in.replace(".parsed.npz", ".jax.rdf.npz")
    rdf.main(["-i", port_in, "-o", port, "--nbins", "32", "--cut", "2",
              "--device", "cpu"])
    jrdf.main(["-i", port_in, "-o", jax, "--nbins", "32", "--cut", "2"])
    return port, jax


def _ideal(boxes, natoms, nbins, rmax):
    """Unordered ideal-gas pair count per shell, (..., nbins) in f64."""
    edges = np.arange(nbins + 1) * (rmax / nbins)
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rho = natoms / np.prod(boxes, axis=-1)
    return 0.5 * natoms * rho[..., None] * shell


def test_rdf_matches_jax(features, parsed):
    """Equal pair counts per frame and bin (the port computes r^2 as XLA
    contracts the JAX package's on the CPU); g, g_mean and S(q) then
    differ only by the f32 rounding of the shell normalisation and the
    sums (rtol 1e-5 of each value, plus 1e-6 absolute); rho within rtol
    1e-6."""
    port, jax = features
    with np.load(parsed[0]) as z:
        boxes = z["boxes"][:, :, 2:].astype(np.float32).astype(np.float64)
    with np.load(port, allow_pickle=True) as p, \
            np.load(jax, allow_pickle=True) as j:
        assert sorted(p.files) == sorted(j.files)
        assert p["g_mean"].shape == (2, 6, 32) and p["g"].shape == (2, 6, 6,
                                                                    32)
        rmax = float(p["rmax"])
        assert rmax == pytest.approx(float(j["rmax"]), rel=1e-12)
        ideal = _ideal(boxes, 256, 32, rmax)
        dcount = np.rint((p["g"] - j["g"]) * ideal)
        assert not dcount.any()
        assert np.rint(j["g"] * ideal).sum() > 0
        np.testing.assert_allclose(p["g"], j["g"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p["g_mean"], j["g_mean"], rtol=1e-5,
                                   atol=1e-6)
        scale = float(np.abs(j["sq"]).max())
        np.testing.assert_allclose(p["sq"], j["sq"], rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(p["q"], j["q"], rtol=1e-6)
        np.testing.assert_allclose(p["rho"], j["rho"], rtol=1e-6)
        np.testing.assert_array_equal(p["temp"], j["temp"])
        np.testing.assert_array_equal(p["press"], j["press"])


def test_neural_and_post(features, capsys):
    port_in, _ = features
    port = port_in.replace(".rdf.npz", ".melt.npz")
    jax = port_in.replace(".port.rdf.npz", ".jax.melt.npz")
    kw = ["--model", "mlp", "--epochs", "150", "--band", "1"]
    neural.main(["-i", port_in, "-o", port, "--device", "cpu"] + kw)
    jneural.main(["-i", port_in, "-o", jax] + kw)
    spacing = (1.6 - 0.4) / 5
    with np.load(port) as p, np.load(jax) as j:
        assert sorted(p.files) == sorted(j.files)
        assert p["tm"].shape == (2,) and np.isfinite(p["tm"]).all()
        assert np.abs(p["tm"] - j["tm"]).max() < spacing, (p["tm"], j["tm"])
        np.testing.assert_array_equal(p["temp"], j["temp"])
        np.testing.assert_array_equal(p["press"], j["press"])
        assert p["losses"].shape == (150,)
    capsys.readouterr()
    post.main(["-i", port, "--no-plot"])
    rows = [ln for ln in capsys.readouterr().out.splitlines() if "T_m=" in ln]
    assert len(rows) == 2 and rows[0].strip().startswith("P=")


@pytest.mark.parametrize("engine,item", [("dense", "A14")])
def test_remcmc_unported_engines_raise(tmp_path, monkeypatch, engine, item):
    """The dense engine runs in one process; like the JAX runner it
    refuses several, before any collective."""
    from neuralmelting_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        remcmc.main(MINI + ["-o", str(tmp_path), "--device", "cpu",
                            "--engine", engine])


@pytest.mark.parametrize("flags", [["--coordinator", "localhost:1234"],
                                   ["--nprocs", "2", "--procid", "0"]])
def test_remcmc_multiprocess_raises(tmp_path, flags):
    """The multi-process flags come together: one without the others
    raises before any process group is joined (two ranks run in
    tests/test_torch_multiproc.py)."""
    with pytest.raises(ValueError, match="--coordinator, --nprocs and "
                                         "--procid together"):
        remcmc.main(MINI + ["-o", str(tmp_path), "--device", "cpu"] + flags)


def test_stages_default_to_the_card(tmp_path, features):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    port_rdf, _ = features
    with pytest.raises(RuntimeError, match="CUDA"):
        remcmc.main(MINI + ["-o", str(tmp_path), "--engine", "cellmc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        rdf.main(["-i", port_rdf.replace(".port.rdf.npz", ".parsed.npz"),
                  "-o", str(tmp_path / "x.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        neural.main(["-i", port_rdf, "-o", str(tmp_path / "y.npz")])


def test_remcmc_no_traj_and_profile(tmp_path):
    """--no-traj writes no frames; --profile DIR writes a torch.profiler
    Chrome trace of the run into DIR."""
    out, prof = tmp_path / "o", tmp_path / "prof"
    remcmc.main(["-n", "p", "-ss", "4", "-pn", "1", "-tn", "2", "-sn", "1",
                 "-sm", "1", "-o", str(out), "--device", "cpu", "--no-traj",
                 "--profile", str(prof)])
    assert len(list(out.glob("p.lj.fcc.4x4x4.*.thrm"))) == 2
    assert list(out.glob("*.traj")) == []
    trace = json.loads((prof / "remcmc.trace.json").read_text())
    assert trace["traceEvents"]
