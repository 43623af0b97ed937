"""The port's bench (``python -m neuralmelting_tpu_torch.bench``) on the
CPU at a tiny size: one JSON line of scalars with every named key, rates
> 0 and diag 0 in each row; its configurations are the JAX bench's
(bench.py:137-155) and scripts/eambench.py's (:48-65); the kernel row's
``adapt=False`` keeps the acceptance counters and step sizes; without
CUDA the default device raises. Rates from a CPU run are not device
numbers; the test checks only that they are positive."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import bench, runner
from neuralmelting_tpu_torch.sampler import cellmc as SC

KEYS = {"lj_kernel_moves_per_sec", "lj_kernel_sec_per_chunk",
        "lj_kernel_diag", "lj_kcap", "lj_e2e_moves_per_sec",
        "lj_e2e_sec_per_chunk", "lj_e2e_diag", "lj_natoms", "lj_replicas",
        "eam_moves_per_sec", "eam_sec_per_chunk", "eam_diag", "eam_kcap",
        "eam_natoms", "eam_replicas", "sweeps_per_chunk", "device",
        "gpu_name", "power_limit_w"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors run fastest on one thread; the tests share the machine
    with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny():
    cf = bench.configs()
    return {"lj": dataclasses.replace(cf["lj"], ncells=(4, 4, 4), npress=1,
                                      ntemp=2, press=(1.0,), temp=(0.7, 1.3),
                                      mod=2),
            "eam": dataclasses.replace(cf["eam"], ncells=(4, 4, 4),
                                       npress=1, ntemp=2, press=(1.0,),
                                       temp=(600.0, 1400.0), mod=2)}


def test_report_prints_one_json_line(capsys):
    row = bench.report(tiny(), "cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == row and set(got) == KEYS
    for k, v in got.items():
        assert v is None or isinstance(v, (int, float, str)), k
    for k in ("lj_kernel_moves_per_sec", "lj_e2e_moves_per_sec",
              "eam_moves_per_sec"):
        assert got[k] > 0, k
    for k in ("lj_kernel_diag", "lj_e2e_diag", "eam_diag"):
        assert got[k] == 0, k
    assert got["lj_natoms"] == got["eam_natoms"] == 256
    assert got["lj_replicas"] == got["eam_replicas"] == 2
    assert got["device"] == "cpu" and got["gpu_name"] is None


def test_configs_are_the_jax_benches():
    cf = bench.configs()
    lj, al = cf["lj"], cf["eam"]
    assert (lj.element, lj.ncells, lj.seed, lj.dpos0, lj.dvol0, lj.mod,
            lj.nsmpl) == ("LJ", (16, 8, 8), 1234, 0.11, 0.002, 20, 1)
    np.testing.assert_allclose(lj.press, np.linspace(1.0, 8.0, 32))
    np.testing.assert_allclose(lj.temp, np.linspace(0.7, 1.3, 32))
    assert (al.element, al.ncells, al.seed, al.dpos0, al.dvol0, al.mod,
            al.nsmpl) == ("AL", (16, 8, 8), 11, 0.15, 0.002, 20, 1)
    np.testing.assert_allclose(al.press, np.linspace(1.0, 5000.0, 16))
    np.testing.assert_allclose(al.temp, np.linspace(600.0, 1400.0, 16))
    assert (bench.WARM_CHUNKS, bench.TIMED_CHUNKS, bench.E2E_RECORDS) == \
        (2, 3, 10)


@pytest.mark.parametrize("adapt", [False, True])
def test_adapt_off_keeps_counters_and_steps(adapt):
    cfg = tiny()["lj"]
    s = runner.setup_run(cfg, engine="cellmc", device="cpu")
    run = SC.make_cellmc_run_fn(
        s.us.kb, s.us.p2e, s.geom, mod=2, nrecords=2,
        ncyc=SC.default_ncyc(s.geom), nvol=1, exchange=False, adapt=adapt)
    dpos0 = s.states.dpos.clone()
    states, *_ = run(s.states, s.slabs, s.slab_count, s.shift, s.pot,
                     s.cell_tabs, (cfg.seed, cfg.seed + 7))
    if adapt:
        assert int(states.ntp.sum()) == 0          # zeroed every record
        assert not torch.equal(states.dpos, dpos0)
    else:
        per_sweep = SC.default_ncyc(s.geom) * s.geom.ncells * min(
            s.geom.nsub, s.natoms // s.geom.ncells)
        assert (states.ntp == 4 * per_sweep).all()  # 2 records x 2 sweeps
        assert (states.ntv == 4).all()
        assert torch.equal(states.dpos, dpos0)


def test_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
