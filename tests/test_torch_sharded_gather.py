"""The gather engine over two gloo ranks on the CPU, held bit for bit to
the port's own one-process run (tests/torch_shard_worker.py, mode
"gather"; one thread a process).

That run is the oracle because gather sharding folds nothing into any
seed: every replica keeps its global key ``fold_in(key(seed), r)``, a
pass's draws, the lists, the moves and the adaptation are per replica,
the rebuild decisions are ORed over the ranks (the JAX engine's
``jnp.any(stale)`` over the whole ensemble) and the exchange draws its
uniforms from one key on every rank. The JAX package runs the same
program on one process under GSPMD, and the one-process port is held to
it elsewhere (tests/test_torch_gather_*.py).

- LJ with HMC (256 atoms, a 1 x 4 grid: rank 0 holds the two cold
  replicas, rank 1 the two hot ones, so rank 0 rebuilds for rank 1) and
  EAM (256 Al atoms, R = 4): two chunks, each rank's rebuild and sync
  counts the one process's; records, frames, hist, xacc, diag, the final
  states (keys included), ``slot_of`` and the lists' reference positions
  equal;
- restarts: a 2-rank checkpoint resumed on 2 ranks and in one process, a
  1-process checkpoint on 2 ranks, and one stripped of the lists' extras
  (the JAX layout) on 2 ranks against one process's resume of it;
- a chunk in which one rank alone raises CB_INVALID returns it on both;
- ``remcmc --coordinator`` with the default engine writes the .thrm and
  .traj files of one-process ``remcmc``, byte for byte.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.cli import remcmc
from neuralmelting_tpu_torch.io import checkpoint as ckpt
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.sampler import checkerboard as CB

import torch_chunk_case as CC
import torch_shard_worker as W

ARGS = ["-n", "mg", "-e", "LJ", "-ss", "4", "-pn", "2", "-pr", "1", "4",
        "-tn", "2", "-tr", "0.6", "1.4", "-sn", "2", "-sm", "2", "-sd", "5",
        "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _remcmc_ranks(outdir):
    """remcmc's two ranks, the default engine, started."""
    port = CC.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "neuralmelting_tpu_torch.cli.remcmc"] + ARGS
        + ["-o", outdir, "--coordinator", f"127.0.0.1:{port}", "--nprocs",
           "2", "--procid", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for i in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outcomes and the one process's, computed while the
    ranks run (the 1-process checkpoint first: the ranks resume it)."""
    d = tmp_path_factory.mktemp("sg")
    eam_gen.write_setfl(str(d / W.TABLE), rc=3.8)
    s, one = W.gather_chunk(W.gather_setup(d, "lj"), "lj_c0",
                            checkpoint_path=str(d / "one.npz"))
    states, slot_of, cfg_json, _ = ckpt.load(str(d / "one.npz"))
    ckpt.save(str(d / "noref.npz"), states, slot_of, cfg_json)
    ranks = CC.start_ranks("gather", d, d / "gather.npz")
    cli = _remcmc_ranks(str(d / "cli2"))
    one.update(W.gather_chunk(s, "lj_c1")[1])
    s, got = W.gather_chunk(W.gather_setup(d, "eam"), "eam_c0")
    one.update(got)
    one.update(W.gather_chunk(s, "eam_c1")[1])
    one.update(W.gather_chunk(runner.restore_setup(
        W.gather_setup(d, "lj"), str(d / "noref.npz")), "re_noref")[1])
    remcmc.main(ARGS + ["-o", str(d / "cli1")])
    CC.wait_ranks(ranks)
    logs = []
    for i, p in enumerate(cli):
        logs.append(p.communicate(timeout=240)[0].decode())
        assert p.returncode == 0, f"remcmc rank {i} failed:\n{logs[-1]}"
    # 2 -> 1: the ranks' checkpoint resumed in this process
    one.update(W.gather_chunk(runner.restore_setup(
        W.gather_setup(d, "lj"), str(d / "two.npz")), "re_two_in_one")[1])
    return dict(one=one, two=dict(np.load(d / "gather.npz")), d=d,
                logs=logs)


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), what


def _hold(two, one, tag2, tag1):
    """Every outcome of ``tag2`` (the ranks') equals ``tag1``'s (the one
    process's): the values bit for bit, each rank's diag and counts of
    rebuilds and syncs those of the one process."""
    keys = [k[len(tag2) + 1:] for k in two if k.startswith(tag2 + "_")]
    assert {"r_pe", "s_pos", "key", "ref_pos", "hist"} <= set(keys)
    for k in keys:
        a, b = two[f"{tag2}_{k}"], one[f"{tag1}_{k}"]
        if k == "counts":            # rebuilds, syncs, remote rebuilds
            assert b.shape == (1, 3) and b[0, 2] == 0
            _same(a[:, :2], np.repeat(b[:, :2], 2, axis=0), k)
        elif k == "diag":
            _same(a, np.repeat(b, 2), k)
        else:
            _same(a, b, f"{tag2} {k}")


@pytest.mark.parametrize("style", ["lj", "eam"])
@pytest.mark.parametrize("chunk", [0, 1])
def test_two_ranks_make_the_one_process_chunk(runs, style, chunk):
    two, one = runs["two"], runs["one"]
    tag = f"{style}_c{chunk}"
    _hold(two, one, tag, tag)
    assert (one[f"{tag}_diag"] == 0).all()
    assert one[f"{tag}_counts"][0, 0] > 0         # the lists were rebuilt
    assert one[f"{tag}_frame_pos"].shape[1] == 4
    for row in two[f"{tag}_hist"]:
        assert sorted(row.tolist()) == [0, 1, 2, 3]


def test_lj_rank_rebuilds_for_the_other(runs):
    # rank 0's cold replicas raised no flag where rank 1's hot ones did
    two = runs["two"]
    remote = sum(two[f"lj_c{k}_counts"][:, 2] for k in (0, 1))
    assert remote.max() > 0
    assert (two["lj_c0_r_acc_hmc"] > 0).any()        # HMC ran
    assert two["lj_c0_xacc"].sum() + two["lj_c1_xacc"].sum() > 0


@pytest.mark.parametrize("tag2, tag1", [
    ("re_two", "lj_c1"),                # 2 -> 2
    ("re_one", "lj_c1"),                # 1 -> 2
    ("re_noref", "re_noref"),           # the JAX layout, 2 against 1
])
def test_restart_on_two_ranks(runs, tag2, tag1):
    _hold(runs["two"], runs["one"], tag2, tag1)


def test_two_rank_checkpoint_resumes_in_one_process(runs):
    one = runs["one"]
    keys = [k[len("lj_c1_"):] for k in one if k.startswith("lj_c1_")]
    for k in keys:
        _same(one[f"re_two_in_one_{k}"], one[f"lj_c1_{k}"], k)
    states, slot_of, _, extra = ckpt.load(str(runs["d"] / "two.npz"))
    assert states.pos.shape == (4, 256, 3) and extra["nl_ref_pos"].shape \
        == (4, 256, 3) and extra["nl_ref_box"].shape == (4, 3)


def test_one_rank_raises_cb_invalid_both_return_it(runs):
    diag = runs["two"]["cb_diag"]
    assert diag.shape == (2,) and diag[0] == diag[1]
    assert diag[0] & CB.DIAG_CB_INVALID


def test_remcmc_default_engine_two_ranks_writes_one_process_files(runs):
    d, logs = runs["d"], runs["logs"]
    summary = json.loads(logs[0].strip().splitlines()[-1])
    assert summary["diag"] == 0 and summary["replicas"] == 4
    assert '"diag"' not in logs[1]              # rank 1 prints no summary
    names = sorted(os.path.basename(p) for p in glob.glob(
        str(d / "cli1" / "mg.lj.*.t*")))
    assert len(names) == 8                      # a .thrm and a .traj a slot
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        str(d / "cli2" / "mg.lj.*.t*")))
    for n in names:
        with open(d / "cli1" / n, "rb") as f1, open(d / "cli2" / n,
                                                    "rb") as f2:
            assert f1.read() == f2.read(), n
