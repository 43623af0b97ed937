"""Multi-process runs of the port on the CPU: two gloo ranks, one thread
each.

- ``remcmc --coordinator ... --nprocs 2 --device cpu --engine cellmc``:
  rank 0 alone prints the summary and writes one .thrm/.traj per slot,
  one metrics line and the checkpoint; the checkpoint holds the whole
  ensemble in the single-process layout and resumes in one process, and
  ``remcmc --restart`` resumes it on two ranks (the sweep counter goes
  on; ``--profile`` writes a trace a rank).
- ``runner.restore_setup`` under two processes (tests/torch_shard_worker.py,
  mode "restart"): a 2-rank checkpoint resumed on 2 ranks continues bit
  for bit, LJ and EAM; a 1-process checkpoint comes back on 2 ranks with
  its positions, boxes, slots and slabs exact (its chain then rightly
  parts from the 1-process one: the shard is folded into the seeds); a
  checkpoint without slabs re-bins with a warning; one of another R is
  refused on every rank.
- Under two processes the gather engine sets up with each rank's half
  of the replicas, ``exchange=False`` raises the JAX runner's
  ValueError (ROADMAP C14), and a chunk whose ranks raise different diag
  bits (CB_INVALID on one, SLAB_OVERFLOW on the other) returns their
  bitwise OR on both (tests/torch_shard_worker.py, mode "c13"; ROADMAP
  C13).
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
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.sampler import cellmc as SC

import torch_chunk_case as CC
import torch_shard_worker as W

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


def _remcmc(port, outdir, extra=()):
    """remcmc's two ranks on ``port``, started."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "neuralmelting_tpu_torch.cli.remcmc"] + ARGS
        + ["-o", outdir, "--coordinator", f"127.0.0.1:{port}", "--nprocs",
           "2", "--procid", str(i)] + list(extra), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for i in range(2)]


def _logs(procs, what):
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} rank {i} failed:\n{log[-3000:]}"
    return logs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The remcmc ranks, the c13 ranks and the restart ranks, started
    together; then remcmc's ranks again, resuming the first pair's
    checkpoint."""
    d = tmp_path_factory.mktemp("mp")
    out = str(d / "out")
    cli = _remcmc(CC.free_port(), out)
    CC.save_inputs(d / "in.npz", CC.lj_case())
    c13 = CC.start_ranks("c13", d / "in.npz", d / "c13.npz")
    # the restart ranks' inputs: the table and a 1-process checkpoint,
    # with the port's extras and without them (the JAX layout)
    rs = d / "restart"
    rs.mkdir()
    eam_gen.write_setfl(str(rs / W.TABLE), rc=3.8)
    one = str(rs / "one.npz")
    runner.run_sampling(
        runner.setup_run(W.RESTART_CFGS["lj"], engine="cellmc",
                         device="cpu"), write_files=False,
        checkpoint_path=one)
    states, slot_of, cfg_json, _ = ckpt.load(one)
    ckpt.save(str(rs / "noslab.npz"), states, slot_of, cfg_json)
    restart = CC.start_ranks("restart", rs, d / "restart.npz")
    logs = _logs(cli, "remcmc")
    out2, prof = str(d / "out2"), str(d / "prof")
    resumed = _remcmc(CC.free_port(), out2, [
        "--restart", os.path.join(out, "mp.lj.ckpt.npz"), "--profile", prof])
    CC.wait_ranks(c13)
    CC.wait_ranks(restart)
    return dict(out=out, logs=logs, c13=dict(np.load(d / "c13.npz")),
                restart=dict(np.load(d / "restart.npz")), rs=rs,
                out2=out2, prof=prof,
                resumed_logs=_logs(resumed, "remcmc --restart"))


def test_rank_zero_alone_writes(two_ranks):
    out, logs = two_ranks["out"], two_ranks["logs"]
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
    out = two_ranks["out"]
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
    c13 = two_ranks["c13"]
    # the gather engine sets up on two ranks, each with its R / 2 rows
    # (tests/test_torch_sharded_gather.py runs it); exchange=False is
    # refused as the JAX runner refuses it
    assert sorted(c13["refused"].tolist()) == [
        "gather:1 of 2 rows", "no_exchange:ValueError"]
    assert int(c13["diag"]) == SC.DIAG_CB_INVALID | SC.DIAG_SLAB_OVERFLOW


@pytest.mark.parametrize("style", ["lj", "eam"])
def test_two_rank_checkpoint_resumes_on_two_ranks_bit_for_bit(two_ranks,
                                                              style):
    got = two_ranks["restart"]
    a = {k[len(style) + 3:]: v for k, v in got.items()
         if k.startswith(f"{style}_a_")}
    b = {k[len(style) + 3:]: v for k, v in got.items()
         if k.startswith(f"{style}_b_")}
    assert set(a) == set(b) and "r_pe" in a and "s_pos" in a
    assert int(a["diag"]) == 0
    assert a["hist"].shape == (2, 4) and a["frame_pos"].shape[1] == 4
    assert (a["r_acc_pos"] > 0).all() and (a["r_acc_vol"] > 0).any()
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def test_one_process_checkpoint_resumes_on_two_ranks(two_ranks):
    got = two_ranks["restart"]
    states, slot_of, _, extra = ckpt.load(str(two_ranks["rs"] / "one.npz"))
    # the restored shards, gathered in rank order: the checkpoint's rows
    assert torch.equal(torch.as_tensor(got["one_restored_s_pos"]),
                       states.pos)
    assert torch.equal(torch.as_tensor(got["one_restored_s_box"]),
                       states.box)
    assert torch.equal(torch.as_tensor(got["one_restored_slot_of"]),
                       slot_of)
    np.testing.assert_array_equal(got["one_restored_slab_xyz"],
                                  extra["slab_xyz"])
    np.testing.assert_array_equal(got["one_restored_slab_ids"],
                                  extra["slab_ids"])
    np.testing.assert_array_equal(got["one_restored_shift"], extra["shift"])
    # the energies rebuilt on each shard are the last record's
    np.testing.assert_allclose(got["one_restored_s_pe"], states.pe.numpy(),
                               rtol=1e-6)
    assert int(got["one_resumed_diag"]) == 0
    for row in got["one_resumed_hist"]:
        assert sorted(row.tolist()) == [0, 1, 2, 3]
    assert (got["one_resumed_r_sweep"] == int(states.sweep[0]) + 3).all()


def test_checkpoint_without_slabs_rebins_on_two_ranks(two_ranks):
    got = two_ranks["restart"]
    states, _, _, _ = ckpt.load(str(two_ranks["rs"] / "noslab.npz"))
    assert got["noslab_warned"].tolist() == [1, 1]
    assert not got["noslab_restored_shift"].any()
    assert torch.equal(torch.as_tensor(got["noslab_restored_s_pos"]),
                       states.pos)
    assert int(got["noslab_resumed_diag"]) == 0
    for row in got["noslab_resumed_hist"]:
        assert sorted(row.tolist()) == [0, 1, 2, 3]


def test_wrong_ensemble_is_refused_on_every_rank(two_ranks):
    # both ranks raised ValueError, went on and met in a collective
    assert two_ranks["restart"]["wrong_r_refused"].tolist() == [1, 1]


def test_remcmc_restart_on_two_ranks(two_ranks):
    logs = two_ranks["resumed_logs"]
    summary = json.loads(logs[0].strip().splitlines()[-1])
    assert summary["diag"] == 0 and summary["replicas"] == 4
    assert '"diag"' not in logs[1]              # rank 1 prints no summary
    old, _, _, _ = ckpt.load(os.path.join(two_ranks["out"],
                                          "mp.lj.ckpt.npz"))
    new, slot_of, _, _ = ckpt.load(os.path.join(two_ranks["out2"],
                                                "mp.lj.ckpt.npz"))
    assert (old.sweep == 6).all() and (new.sweep == 12).all()
    assert sorted(slot_of.tolist()) == [0, 1, 2, 3]
    _, rows = thermo.read(sorted(glob.glob(os.path.join(
        two_ranks["out2"], "mp.lj.fcc.4x4x4.*.thrm")))[0])
    assert rows["sweep"].tolist() == [9, 12]


def test_remcmc_profile_writes_a_trace_a_rank(two_ranks):
    names = sorted(os.listdir(two_ranks["prof"]))
    assert names == ["remcmc.rank0.trace.json", "remcmc.rank1.trace.json"]
    for n in names:
        with open(os.path.join(two_ranks["prof"], n)) as f:
            assert json.load(f)["traceEvents"]
