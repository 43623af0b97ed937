"""Multi-process runs of the port on the CPU: two gloo ranks, one thread
each.

- ``remcmc --coordinator ... --nprocs 2 --device cpu --engine cellmc``:
  rank 0 alone prints the summary and writes one .thrm/.traj per slot,
  one metrics line and the checkpoint; the checkpoint holds the whole
  ensemble in the single-process layout and resumes in one process.
- Under two processes the gather engine, ``restore_setup`` and
  ``exchange=False`` raise NotImplementedError naming ROADMAP A12 (rest),
  and a chunk whose ranks raise different diag bits (CB_INVALID on one,
  SLAB_OVERFLOW on the other) returns their bitwise OR on both
  (tests/torch_shard_worker.py, mode "c13"; ROADMAP C13).
"""

import glob
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.io import checkpoint as ckpt
from neuralmelting_tpu_torch.io import thermo
from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.sampler import cellmc as SC

import torch_chunk_case as CC

ARGS = ["-n", "mp", "-e", "LJ", "-ss", "4", "-pn", "2", "-pr", "1", "4",
        "-tn", "2", "-tr", "0.6", "1.4", "-sn", "2", "-sm", "3", "-sd", "5",
        "--device", "cpu", "--engine", "cellmc"]
CFG = RunConfig(name="mp", element="LJ", ncells=(4, 4, 4), npress=2,
                press=(1.0, 4.0), ntemp=2, temp=(0.6, 1.4), nsmpl=2, mod=3,
                seed=5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The remcmc ranks and the c13 ranks, all four started together."""
    d = tmp_path_factory.mktemp("mp")
    out = str(d / "out")
    port = str(CC.free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cli = [subprocess.Popen(
        [sys.executable, "-m", "neuralmelting_tpu_torch.cli.remcmc"] + ARGS
        + ["-o", out, "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
           "--procid", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for i in range(2)]
    CC.save_inputs(d / "in.npz", CC.lj_case())
    c13 = CC.start_ranks("c13", d / "in.npz", d / "c13.npz")
    logs = [p.communicate(timeout=240)[0].decode() for p in cli]
    for i, (p, log) in enumerate(zip(cli, logs)):
        assert p.returncode == 0, f"remcmc rank {i} failed:\n{log[-3000:]}"
    CC.wait_ranks(c13)
    return out, logs, dict(np.load(d / "c13.npz"))


def test_rank_zero_alone_writes(two_ranks):
    out, logs, _ = two_ranks
    summary = json.loads(logs[0].strip().splitlines()[-1])
    assert summary["diag"] == 0 and summary["replicas"] == 4
    assert '"diag"' not in logs[1]              # rank 1 prints no summary
    thrm = sorted(glob.glob(os.path.join(out, "mp.lj.fcc.4x4x4.*.thrm")))
    traj = glob.glob(os.path.join(out, "mp.lj.fcc.4x4x4.*.traj"))
    assert len(thrm) == len(traj) == 4          # one per slot
    for path in thrm:
        _, rows = thermo.read(path)
        assert rows["pe"].shape == (2,) and np.isfinite(rows["pe"]).all()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["replicas"] == 4


def test_checkpoint_is_whole_and_resumes_in_one_process(two_ranks):
    out, _, _ = two_ranks
    path = os.path.join(out, "mp.lj.ckpt.npz")
    states, slot_of, cfg_json, extra = ckpt.load(path)
    assert states.pos.shape == (4, 256, 3) and sorted(
        slot_of.tolist()) == [0, 1, 2, 3]
    assert extra["slab_ids"].shape[0] == 4
    assert (states.sweep == 6).all() and cfg_json == CFG.to_json()
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # the slabs come back as
        s = runner.restore_setup(               # they were: no re-binning
            runner.setup_run(CFG, engine="cellmc", device="cpu"), path)
    assert mesh.process_count() == 1
    assert torch.equal(s.states.pos, states.pos)
    assert torch.equal(s.states.box, states.box)
    # the energies rebuilt from the restored slabs are the last record's
    np.testing.assert_allclose(s.states.pe.numpy(), states.pe.numpy(),
                               rtol=1e-6)
    s, recs, _, hist, _, diag = runner.run_sampling(s, write_files=False,
                                                    write_traj=False,
                                                    nrecords=1)
    assert diag == 0 and hist.shape == (1, 4)
    assert (recs.sweep == 9).all() and torch.isfinite(recs.pe).all()


def test_refusals_and_diag_or_under_two_processes(two_ranks):
    _, _, c13 = two_ranks
    assert sorted(c13["refused"].tolist()) == ["gather", "no_exchange",
                                               "restore"]
    assert int(c13["diag"]) == SC.DIAG_CB_INVALID | SC.DIAG_SLAB_OVERFLOW
