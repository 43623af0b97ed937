"""EAM on the gather engine through the port's entry points, on the CPU.

256 fcc Al atoms (4^3) on the rc 3.8 table, the smallest box the
stride-2 checkerboard at the interaction range 2 rc admits:

- ``runner.setup_run`` with element "AL" runs the default engine, gather,
  on the device tables (``models.eam.EAMTables``), with the JAX runner's
  cells (stride 2 at 2 rc) and list capacity; a chunk with exchange
  against the JAX runner's chunk of the same config: hist, xacc, keys and
  record decisions (sweep, temp, press, acc_pos, acc_vol, dpos, dvol)
  equal, pe rtol 1e-5, vol rtol 1e-6, frames within 1e-5 of the box edge
  (the tolerances of tests/test_torch_gather_engine.py), the virial
  within 1e-5 of its summed pair-term magnitudes at the record's frame
  (at 1 bar it nearly cancels: ``eam_energy.virial_scale``); the
  density cache after the chunk equals ``rho_sums`` from scratch bit for
  bit;
- ``runner.liquid_start`` melts and restores every replica's slot
  temperature, diag 0;
- ``melting_pipeline`` with no engine named runs gather for EAM;
- ``remcmc -e AL --setfl`` runs on the CPU, with and without ``--phmc``
  (then trying HMC moves).
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
from neuralmelting_tpu_torch.models import eam as TE
from neuralmelting_tpu_torch.models import eam_gen
from neuralmelting_tpu_torch.ops import eam_energy as EE
from neuralmelting_tpu_torch.ops import neighbors as NB
from neuralmelting_tpu_torch.parallel import ensemble as ENS

_KW = dict(name="ga", element="AL", ncells=(4, 4, 4), npress=1, ntemp=2,
           press=(1.0,), temp=(900.0, 1000.0), nsmpl=2, mod=2, ncut=0,
           seed=5, dpos0=0.1, dvol0=0.01)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eam") / "al38.eam.alloy")
    eam_gen.write_setfl(path, rc=3.8)
    return path


def record_virial_scale(setup, frames):
    """(nrec, R) summed virial-term magnitudes at each record's frame
    (frames hold the record's positions and boxes)."""
    rlist = NB.f32_rlist(setup.pot.rc_host, setup.cfg.skin)
    return np.stack([EE.virial_scale(
        setup.pot, pos, box, NB.build(pos, box, rlist, setup.cap)).numpy()
        for pos, box in zip(*frames)])


def test_chunk_matches_jax_runner(table):
    js = JR.setup_run(JConfig(**_KW), setfl=table)
    js, jrec, jfr, jhist, jx, jdiag = JR.run_sampling(js, write_files=False)
    ts = runner.setup_run(RunConfig(**_KW), setfl=table, device="cpu")
    assert ts.engine == "gather" and ts.style == "eam"
    assert isinstance(ts.pot, TE.EAMTables)
    assert ts.cellcfg.ncell == js.cellcfg.ncell == (2, 2, 2)
    assert ts.cellcfg.stride == 2 and ts.cap == js.cap
    assert ts.aux.shape == (2, 256)
    ts, trec, tfr, thist, tx, tdiag = runner.run_sampling(ts,
                                                          write_files=False)
    assert int(jdiag) == 0 and tdiag == 0
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(
        ts.states.key.numpy(), np.asarray(jax.random.key_data(js.states.key)))
    for f in ("sweep", "temp", "press", "acc_pos", "acc_vol", "dpos",
              "dvol"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), f)
    assert float(trec.acc_pos.min()) > 0
    for f, tol in (("pe", 1e-5), ("vol", 1e-6)):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)), rtol=tol,
                                   err_msg=f)
    gap = np.abs(trec.virial.numpy() - np.asarray(jrec.virial))
    assert (gap <= 1e-5 * record_virial_scale(ts, tfr)).all(), gap
    np.testing.assert_allclose(tfr[0].numpy(), np.asarray(jfr[0]), rtol=0,
                               atol=1e-5 * float(np.max(np.asarray(jfr[1]))))
    st = ts.states
    assert torch.equal(ts.aux, EE.rho_sums(ts.pot, st.pos, st.box, ts.nls))
    assert (trec.pe.numpy() / 256 < -2.5).all()


def test_liquid_start(table):
    cfg = RunConfig(**dict(_KW, mod=1, temp=(700.0, 900.0)))
    s = runner.setup_run(cfg, setfl=table, device="cpu")
    hot = runner.liquid_start(s, nrecords=2)
    np.testing.assert_array_equal(hot.states.temp[hot.slot_of.long()]
                                  .numpy(), np.float32(cfg.temp))
    assert hot.states.sweep.tolist() == [2, 2]
    _, recs, _, _, _, diag = runner.run_sampling(hot, write_files=False,
                                                 nrecords=1)
    assert diag == 0 and recs.sweep.tolist() == [[3, 3]]


def test_pipeline_runs_eam_on_gather(table):
    cfg = RunConfig(name="gp", element="AL", ncells=(4, 4, 4), npress=1,
                    ntemp=4, press=(1.0,), temp=(400.0, 1200.0, 2000.0,
                                                 2800.0),
                    nsmpl=3, mod=2, ncut=1, seed=2, dpos0=0.1, dvol0=0.01)
    ENS.reset_counts()
    res = TP.melting_pipeline(cfg, setfl=table, nbins=16, model="mlp",
                              epochs=20, band=1, device="cpu")
    assert ENS.COUNTS["sweeps"] == 3 * 2 and ENS.COUNTS["rebuilds"] > 0
    assert res.diag == 0 and np.isfinite(res.tm).all()
    assert res.probs.shape == (1, 4) and res.moves_tried > 0


@pytest.mark.parametrize("hmc", [[], ["--phmc", "0.05", "-ns", "8"]],
                         ids=["plain", "hmc"])
def test_remcmc_al_on_gather(tmp_path, capsys, table, hmc):
    out = str(tmp_path / "o")
    ENS.reset_counts()
    remcmc.main(["-n", "a", "-e", "AL", "--setfl", table, "-ss", "4",
                 "-pn", "1", "-tn", "2", "-tr", "700", "1100", "-sn", "2",
                 "-sm", "2", "-sd", "5", "--device", "cpu", "-o", out]
                + hmc)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["diag"] == 0 and summary["natoms"] == 256
    assert ENS.COUNTS["sweeps"] == 4
    rows = [thermo.read(os.path.join(out, f"a.al.fcc.4x4x4.00.0{t}.thrm"))[1]
            for t in range(2)]
    assert all(np.isfinite(r["pe"]).all() for r in rows)
    assert os.path.exists(os.path.join(out, "a.al.ckpt.npz"))
    if hmc:
        assert max(float(np.max(r["acc_hmc"])) for r in rows) > 0
