"""Port parity: the gather engine with EAM (a pass, the tail, a run
without exchange) against the JAX package's ``style="eam"`` engine, from
the same numpy state and jax.random keys.

The state: 256 jittered fcc Al atoms (4^3) on the rc 3.8 / rs 3.0 table,
R = 4 replicas at 500-1400 K and 1 bar with per-replica dpos, lists at
rc + 0.4 and the stride-2 checkerboard at the interaction range 2 rc
(cells (2, 2, 2), one mover a colour), exact energies and the density
cache on both sides (as tests/test_eam.py's ensemble run builds them).

- One pass: the accept counts, and so every decision of the pass, equal;
  positions within 1e-6 of the box edge; pe rtol 1e-5; the density cache
  within 1e-5 of its scale of the JAX cache and of ``rho_sums`` from
  scratch.
- The tail with one volume trial and one HMC move (8 leapfrog steps):
  every try/accept counter equal, box and positions within 1e-5 of the
  box edge, pe and virial rtol 1e-5; the density cache equals
  ``rho_sums`` of the new configuration bit for bit, and the JAX cache
  within 1e-5 of its scale.
- ``make_ensemble_run_fn`` without exchange (2 records of 3 sweeps, one
  volume trial a sweep): diag 0, keys and record decisions (sweep,
  acc_pos, acc_vol, dpos, dvol) equal, pe rtol 1e-5, vol rtol 1e-6,
  frames within 1e-5 of the box edge, the virial within 1e-5 of its
  summed pair-term magnitudes at the record's frame
  (``eam_energy.virial_scale``: at 1 bar it nearly cancels); the cache
  after the last record equals ``rho_sums`` from scratch bit for bit.

Energies are summed in torch's order (XLA's on the JAX side, with its
multiply-adds contracted): a decision could differ only where its margin
is at f32 rounding; on this seed none does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu import units as JU
from neuralmelting_tpu.models import eam as JE
from neuralmelting_tpu.models import eam_gen as JG
from neuralmelting_tpu.ops import cells as JC
from neuralmelting_tpu.ops import potential_ops as JPO
from neuralmelting_tpu.parallel import ensemble as JENS
from neuralmelting_tpu.sampler import checkerboard as JCB
from neuralmelting_tpu.sampler.state import ensemble_init as jax_ensemble
from neuralmelting_tpu_torch import units
from neuralmelting_tpu_torch.models import eam as TE
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cells as C
from neuralmelting_tpu_torch.ops import eam_energy as EE
from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.ops import neighbors as NB
from neuralmelting_tpu_torch.parallel import ensemble as ENS
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler.state import FIELDS, MCState

COUNTERS = ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")
MASS = 26.9815385
U = units.get("metal")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def eam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eam") / "al38.eam.alloy")
    JG.write_setfl(path, rc=3.8, rs=3.0)
    jp = JE.load(path)
    tp = TE.to_device(TE.load(path), "cpu")
    pos, box = make_supercell("fcc", 4.05, 4)
    rng = np.random.default_rng(17)
    pos = ((pos + rng.normal(0, 0.05, pos.shape)) % box).astype(np.float32)
    temps = np.array([500.0, 800.0, 1100.0, 1400.0], np.float32)
    js = jax_ensemble(jp, pos, box, 23, jnp.asarray(temps), jnp.ones(4),
                      0.1, 0.005, 0.00390625,
                      energy_fn=lambda p_, a, b: (jnp.zeros(()),
                                                  jnp.zeros(())))
    js = js.replace(dpos=jnp.asarray([0.04, 0.06, 0.08, 0.1], jnp.float32))
    jl, cap = JENS.build_ensemble_nl(jp, js, 0.4)
    jaux = JENS.build_ensemble_aux(jp, js, jl)
    pe, vir = jax.vmap(lambda p, b, nl: JPO.eam_ops.total(jp, p, b, nl))(
        js.pos, js.box, jl)
    js = js.replace(pe=pe, virial=vir)
    ts = MCState(**{f: _t(np.asarray(getattr(js, f))) for f in FIELDS},
                 key=J.key_data(jax.random.key_data(js.key)))
    tl, _ = ENS.build_ensemble_nl(tp, ts, 0.4, capacity=cap)
    taux = ENS.build_ensemble_aux(tp, ts, tl)
    jcfg = JC.make_cell_config(box, JE.interaction_range(jp), stride=2,
                               dpos_cap=0.25)
    tcfg = C.make_cell_config(box, TE.interaction_range(tp), stride=2,
                              dpos_cap=0.25)
    assert tcfg.ncell == jcfg.ncell == (2, 2, 2)
    assert JU.METAL.kb == U.kb and JU.METAL.p2e == U.p2e
    return dict(jp=jp, tp=tp, js=js, ts=ts, jl=jl, tl=tl, jaux=jaux,
                taux=taux, jcfg=jcfg, tcfg=tcfg, box=box)


def _close_state(js, ts, pos_tol, box, pe_only=False):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.box.numpy(), np.asarray(js.box), rtol=1e-6)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=pos_tol * float(np.max(box)))
    for f in ("pe",) if pe_only else ("pe", "virial"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   err_msg=f)


def _close_rho(taux, jaux, fresh, exact):
    scale = float(fresh.abs().max())
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=0,
                               atol=1e-5 * scale)
    if exact:
        assert torch.equal(taux, fresh)
    else:
        np.testing.assert_allclose(taux.numpy(), fresh.numpy(), rtol=0,
                                   atol=1e-5 * scale)


def test_one_pass(eam):
    js, ts, jcfg, tcfg = eam["js"], eam["ts"], eam["jcfg"], eam["tcfg"]
    pkeys = jax.vmap(lambda k: jax.random.fold_in(k, 2))(js.key)
    tkeys = J.fold_in(ts.key, 2)
    jpass = jax.jit(jax.vmap(JCB.make_cb_pass_fn(U.kb, jcfg, "eam"),
                             in_axes=(None, None, 0, 0, 0, 0, 0)))
    js2, jaux = jpass(eam["jp"], jnp.asarray(jcfg.active_table), js,
                      eam["jl"], eam["jaux"], js.dpos, pkeys)
    ts2, taux = CB.make_cb_pass_fn(U.kb, tcfg, "eam")(
        eam["tp"], ENS.table_tensor(tcfg, "cpu"), ts, eam["tl"],
        eam["taux"], ts.dpos, tkeys)
    assert int(ts2.nap.sum()) > 0 and int(ts2.ntp.sum()) > int(ts2.nap.sum())
    # the virial is not carried through moves (dW = 0) on either side
    _close_state(js2, ts2, 1e-6, eam["box"], pe_only=True)
    assert torch.equal(ts2.virial, ts.virial)
    _close_rho(taux, jaux, EE.rho_sums(eam["tp"], ts2.pos, ts2.box,
                                       eam["tl"]), exact=False)


def test_tail_volume_and_hmc(eam):
    js, ts = eam["js"], eam["ts"]
    ks = jax.vmap(lambda k: jax.random.split(k, 2))(js.key)
    jtail = jax.jit(jax.vmap(JCB.make_cb_tail_fn(
        U.kb, U.p2e, nvol=1, nhmc=1, nstps=8, mass=MASS, style="eam"),
        in_axes=(None, 0, 0, 0, 0, 0)))
    js2, jaux = jtail(eam["jp"], js, eam["jl"], eam["jaux"], ks[:, 0],
                      ks[:, 1])
    tks = J.split(ts.key, 2)
    tail = CB.make_cb_tail_fn(U.kb, U.p2e, nvol=1, nhmc=1, nstps=8,
                              mass=MASS, style="eam")
    ts2, taux = tail(eam["tp"], ts, eam["tl"], eam["taux"], tks[:, 0],
                     tks[:, 1])
    assert int(ts2.nth.sum()) == 4 and int(ts2.ntv.sum()) == 4
    assert int(ts2.nah.sum()) > 0 and int(ts2.nav.sum()) > 0
    _close_state(js2, ts2, 1e-5, eam["box"])
    _close_rho(taux, jaux, EE.rho_sums(eam["tp"], ts2.pos, ts2.box,
                                       eam["tl"]), exact=True)
    assert int(ts.nth.sum()) == 0 and torch.equal(eam["taux"], ENS.
                                                  build_ensemble_aux(
                                                      eam["tp"], ts,
                                                      eam["tl"]))


def test_run_without_exchange(eam):
    js, ts = eam["js"], eam["ts"]
    kw = dict(skin=0.4, capacity=eam["tl"].capacity, mod=3, nrecords=2,
              nvol=1, natoms=256, style="eam")
    jrun = JENS.make_ensemble_run_fn(U.kb, U.p2e, eam["jcfg"], **kw)
    js2, _, jaux, jrec, jfr, jdiag = jrun(
        js, eam["jl"], eam["jaux"], eam["jp"],
        jnp.asarray(eam["jcfg"].active_table))
    trun = ENS.make_ensemble_run_fn(U.kb, U.p2e, eam["tcfg"], **kw)
    ts2, tl2, taux, trec, tfr, tdiag, tried = trun(
        ts, eam["tl"], eam["taux"], eam["tp"],
        ENS.table_tensor(eam["tcfg"], "cpu"))
    assert int(jdiag) == int(tdiag) == 0 and int(tried) > 0
    np.testing.assert_array_equal(ts2.key.numpy(),
                                  np.asarray(jax.random.key_data(js2.key)))
    for f in ("sweep", "acc_pos", "acc_vol", "dpos", "dvol"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), f)
    assert float(trec.acc_vol.max()) > 0
    for f, tol in (("pe", 1e-5), ("vol", 1e-6)):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)), rtol=tol,
                                   err_msg=f)
    scale = np.stack([EE.virial_scale(
        eam["tp"], pos, box, NB.build(pos, box, NB.f32_rlist(
            eam["tp"].rc_host, 0.4), eam["tl"].capacity)).numpy()
        for pos, box in zip(*tfr)])
    gap = np.abs(trec.virial.numpy() - np.asarray(jrec.virial))
    assert (gap <= 1e-5 * scale).all(), gap
    np.testing.assert_allclose(tfr[0].numpy(), np.asarray(jfr[0]), rtol=0,
                               atol=1e-5 * float(np.max(eam["box"])))
    _close_rho(taux, jaux, EE.rho_sums(eam["tp"], ts2.pos, ts2.box, tl2),
               exact=True)
