"""Port parity: the gather engine's pass, tail, exchange and chunk against
the JAX package, from the same numpy state and jax.random keys.

- One checkerboard pass (fcc 3x3x3 = 108 jittered atoms, R = 4, per-replica
  dpos): the permuted colour order and every colour's movers bitwise
  (``pass_draws``, ``bin_particles`` and ``pick_movers`` against the JAX
  pass's own draws and binning); accept counts equal; positions within
  1e-6 of the box edge; pe and virial within rtol 1e-5.
- The tail with one volume trial and one HMC move (8 leapfrog steps), from
  the same state and keys: every try/accept counter equal; box and
  positions within 1e-5 of the box edge and pe, virial within rtol 1e-5.
  The looser position limit allows for HMC's normals, which differ from
  jax.random.normal by a few f32 ulps on ~1% of draws (ops/jrandom.py),
  and for XLA's contracted leapfrog multiply-adds.
- ``make_cb_sweep_fn`` (2 passes and a volume trial, no checks between
  them) from the same state: counters and diag equal, positions within
  1e-6 of the box edge; ``or_reduce`` equal to the JAX one.
- ``make_ensemble_run_fn`` without exchange (2 records x 2 sweeps, one
  volume trial a sweep) from the same state and lists: diag, counters,
  keys and record decisions equal, energies and frames within the limits
  of the chunk below.
- ``exchange_event_keyed`` against the JAX ``exchange_event`` over the
  four phases of a 2x3 grid: slot map, swaps and slot fields equal.
- One chunk with exchange through the runners (2 records x 2 sweeps, a
  2x2 (P, T) grid close enough that swaps are accepted, without and with
  HMC): hist and xacc equal, diag 0 on both sides, record acc_* / dpos /
  dvol / sweep / temp / press equal, pe and virial within rtol 1e-5, vol
  within rtol 1e-6, frames within 1e-5 of the box edge.

Energies are summed in torch's order (XLA's on the JAX side): a decision
could differ only where its margin is at f32 rounding; on these seeds none
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu import runner as JR
from neuralmelting_tpu.config import RunConfig as JConfig
from neuralmelting_tpu.models.lattice import make_supercell
from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.ops import cells as JC
from neuralmelting_tpu.ops import potential_ops as JPO
from neuralmelting_tpu.parallel import ensemble as JENS
from neuralmelting_tpu.sampler import checkerboard as JCB
from neuralmelting_tpu.sampler import tempering as JT
from neuralmelting_tpu.sampler.state import ensemble_init as jax_ensemble
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import cells as C
from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.parallel import ensemble as ENS
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler import tempering
from neuralmelting_tpu_torch.sampler.state import FIELDS, MCState

LAT = 2.0 ** (2.0 / 3.0)
COUNTERS = ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """The same jittered 108-atom ensemble (R = 4) with lists and exact
    energies on both sides."""
    pos, box = make_supercell("fcc", LAT, 3)
    rng = np.random.default_rng(21)
    pos = ((pos + rng.normal(0, 0.04, pos.shape)) % box).astype(np.float32)
    temps = np.array([0.6, 0.9, 1.2, 1.5], np.float32)
    press = np.array([1.0, 1.0, 3.0, 3.0], np.float32)
    jp = JLJ.create()
    js = jax_ensemble(jp, pos, box, 31, jnp.asarray(temps),
                      jnp.asarray(press), 0.1, 0.01, 0.005)
    js = js.replace(dpos=jnp.asarray([0.05, 0.08, 0.1, 0.12], jnp.float32))
    jl, cap = JENS.build_ensemble_nl(jp, js, 0.4)
    pe, vir = jax.vmap(lambda p, b, nl: JPO.pair_ops.total(jp, p, b, nl))(
        js.pos, js.box, jl)
    js = js.replace(pe=pe, virial=vir)
    tp = LJCut.create()
    arrays = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    ts = MCState(**{f: _t(v) for f, v in arrays.items()},
                 key=J.key_data(jax.random.key_data(js.key)))
    tl, _ = ENS.build_ensemble_nl(tp, ts, 0.4, capacity=cap)
    jcfg = JC.make_cell_config(box, 2.5, stride=4)
    tcfg = C.make_cell_config(box, 2.5, stride=4)
    return dict(jp=jp, tp=tp, js=js, ts=ts, jl=jl, tl=tl, jcfg=jcfg,
                tcfg=tcfg, box=box)


def _close_state(js, ts, pos_tol, box):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.box.numpy(), np.asarray(js.box), rtol=1e-6)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=pos_tol * float(np.max(box)))
    for f in ("pe", "virial"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   err_msg=f)


def test_one_pass(pair):
    js, ts, jcfg, tcfg = pair["js"], pair["ts"], pair["jcfg"], pair["tcfg"]
    pkeys = jax.vmap(lambda k: jax.random.fold_in(k, 5))(js.key)
    tkeys = J.fold_in(ts.key, 5)
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.asarray(jax.random.key_data(pkeys)))
    # the movers of every colour, in the permuted order, bitwise
    n, c, m = 108, jcfg.ncolors, jcfg.cells_per_color
    shift, order, u, _, _ = CB.pass_draws(tkeys, c, m, ts.dpos)
    ids, start, count = C.bin_particles(ts.pos, ts.box, tcfg.ncell, shift)
    table = ENS.table_tensor(tcfg, "cpu")
    got = torch.stack([CB.pick_movers(table, order[:, k], count, start, ids,
                                      u[:, k])[0] for k in range(c)], 1)
    for r in range(4):
        ksh, kperm, kcol = jax.random.split(pkeys[r], 3)
        jorder = np.asarray(jax.random.permutation(kperm, c))
        np.testing.assert_array_equal(order[r].numpy(), jorder)
        jids, jstart, jcount = JC.bin_particles(
            js.pos[r], js.box[r], jcfg.ncell,
            jax.random.uniform(ksh, (3,), jnp.float32))
        for k, skey in enumerate(jax.random.split(kcol, c)):
            cells = jcfg.active_table[jorder[k]]
            cnt = np.asarray(jcount)[cells]
            ju = np.asarray(jax.random.uniform(
                jax.random.split(skey, 3)[0], (m,), jnp.float32))
            pick = np.minimum((ju * cnt).astype(np.int32),
                              np.maximum(cnt - 1, 0))
            want = np.asarray(jids)[np.clip(np.asarray(jstart)[cells] + pick,
                                            0, n - 1)]
            np.testing.assert_array_equal(got[r, k].numpy(), want)
    # the pass itself
    jpass = jax.jit(jax.vmap(JCB.make_cb_pass_fn(1.0, jcfg),
                             in_axes=(None, None, 0, 0, 0, 0, 0)))
    js2, _ = jpass(pair["jp"], jnp.asarray(jcfg.active_table), js,
                   pair["jl"], jnp.zeros((4, 0)), js.dpos, pkeys)
    ts2, _ = CB.make_cb_pass_fn(1.0, tcfg)(
        pair["tp"], table, ts, pair["tl"], torch.zeros(4, 0), ts.dpos, tkeys)
    assert int(ts2.nap.sum()) > 0 and int(ts2.ntp.sum()) > int(ts2.nap.sum())
    _close_state(js2, ts2, 1e-6, pair["box"])


def test_tail_volume_and_hmc(pair):
    js, ts = pair["js"], pair["ts"]
    ks = jax.vmap(lambda k: jax.random.split(k, 2))(js.key)
    jtail = jax.jit(jax.vmap(JCB.make_cb_tail_fn(1.0, 1.0, nvol=1, nhmc=1,
                                                 nstps=8, mass=1.0),
                             in_axes=(None, 0, 0, 0, 0, 0)))
    js2, _ = jtail(pair["jp"], js, pair["jl"], jnp.zeros((4, 0)), ks[:, 0],
                   ks[:, 1])
    tks = J.split(ts.key, 2)
    tail = CB.make_cb_tail_fn(1.0, 1.0, nvol=1, nhmc=1, nstps=8, mass=1.0)
    ts2, _ = tail(pair["tp"], ts, pair["tl"], torch.zeros(4, 0),
                  tks[:, 0], tks[:, 1])
    assert int(ts2.nth.sum()) == 4 and int(ts2.ntv.sum()) == 4
    assert int(ts2.nah.sum()) > 0
    _close_state(js2, ts2, 1e-5, pair["box"])
    # the input state is not changed
    assert int(ts.nth.sum()) == 0


def test_sweep_fn_and_or_reduce(pair):
    js, ts = pair["js"], pair["ts"]
    jsweep = jax.jit(jax.vmap(JCB.make_cb_sweep_fn(
        1.0, 1.0, pair["jcfg"], npasses=2, nvol=1),
        in_axes=(None, None, 0, 0, 0)))
    js2, _, jdiag = jsweep(pair["jp"], jnp.asarray(pair["jcfg"].active_table),
                           js, pair["jl"], jnp.zeros((4, 0)))
    ts2, _, tdiag = CB.make_cb_sweep_fn(1.0, 1.0, pair["tcfg"], npasses=2,
                                        nvol=1)(
        pair["tp"], ENS.table_tensor(pair["tcfg"], "cpu"), ts, pair["tl"],
        torch.zeros(4, 0))
    np.testing.assert_array_equal(tdiag.numpy(), np.asarray(jdiag))
    np.testing.assert_array_equal(ts2.key.numpy(),
                                  np.asarray(jax.random.key_data(js2.key)))
    _close_state(js2, ts2, 1e-6, pair["box"])
    flags = np.array([0, 1, 8, 2, 0, 9], np.int32)
    assert int(ENS.or_reduce(_t(flags))) == int(JENS.or_reduce(
        jnp.asarray(flags))) == 11


def test_run_without_exchange(pair):
    js, ts = pair["js"], pair["ts"]
    kw = dict(skin=0.4, capacity=pair["tl"].capacity, mod=2, nrecords=2,
              nvol=1, natoms=108)
    jrun = JENS.make_ensemble_run_fn(1.0, 1.0, pair["jcfg"], **kw)
    js2, _, _, jrec, jfr, jdiag = jrun(
        js, pair["jl"], jnp.zeros((4, 0)), pair["jp"],
        jnp.asarray(pair["jcfg"].active_table))
    trun = ENS.make_ensemble_run_fn(1.0, 1.0, pair["tcfg"], **kw)
    ts2, _, _, trec, tfr, tdiag, tried = trun(
        ts, pair["tl"], torch.zeros(4, 0), pair["tp"],
        ENS.table_tensor(pair["tcfg"], "cpu"))
    assert int(jdiag) == int(tdiag) == 0 and int(tried) > 0
    np.testing.assert_array_equal(ts2.key.numpy(),
                                  np.asarray(jax.random.key_data(js2.key)))
    for f in ("sweep", "acc_pos", "acc_vol", "dpos", "dvol"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), f)
    for f, tol in (("pe", 1e-5), ("virial", 1e-5), ("vol", 1e-6)):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)), rtol=tol)
    np.testing.assert_allclose(tfr[0].numpy(), np.asarray(jfr[0]), rtol=0,
                               atol=1e-5 * float(np.max(pair["box"])))


def test_exchange_event_keyed():
    rng = np.random.default_rng(8)
    npress, ntemp = 2, 3
    r = npress * ntemp
    t_grid = np.tile(np.array([0.7, 0.74, 0.78], np.float32), npress)
    p_grid = np.repeat(np.array([1.0, 1.2], np.float32), ntemp)
    pe = rng.normal(-700, 3, r).astype(np.float32)
    box = (5.0 + rng.normal(0, 0.01, (r, 3))).astype(np.float32)
    slot_of = rng.permutation(r).astype(np.int32)
    fields = {f: rng.random(r).astype(np.float32)
              for f in ("dpos", "dvol", "dt")}
    fields.update({f: rng.integers(0, 9, r).astype(np.int32)
                   for f in ("nap", "ntp", "nav", "ntv", "nah", "nth")})
    pos, _ = make_supercell("fcc", LAT, 1)
    js = jax_ensemble(JLJ.create(), pos, box[0], 1, jnp.asarray(t_grid),
                      jnp.asarray(p_grid), 0.1, 0.01, 0.005)
    js = js.replace(pe=jnp.asarray(pe), box=jnp.asarray(box),
                    **{f: jnp.asarray(v) for f, v in fields.items()})
    ts = MCState(**{f: _t(np.asarray(getattr(js, f))) for f in FIELDS})
    swaps = 0
    for event in range(4):
        key = jax.random.fold_in(jax.random.key(4), event)
        j2, jslot, jn = JT.exchange_event(
            js, jnp.asarray(slot_of), key, event, npress, ntemp,
            jnp.asarray(t_grid), jnp.asarray(p_grid), 1.0, 1.0)
        t2, tslot, tn = tempering.exchange_event_keyed(
            ts, _t(slot_of), J.key_data(jax.random.key_data(key)), event,
            npress, ntemp, _t(t_grid), _t(p_grid), 1.0, 1.0)
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        assert int(tn) == int(jn)
        swaps += int(tn)
        for f in ("temp", "press", *fields):
            np.testing.assert_array_equal(getattr(t2, f).numpy(),
                                          np.asarray(getattr(j2, f)), f)
    assert swaps > 0


_CHUNK = dict(name="g", element="LJ", ncells=(3, 3, 3), npress=2, ntemp=2,
              press=(1.0, 1.3), temp=(0.8, 0.84), nsmpl=2, mod=2, ncut=0,
              seed=3)


@pytest.mark.parametrize("hmc", [{}, {"phmc": 0.05, "nstps": 8}],
                         ids=["plain", "hmc"])
def test_chunk_with_exchange(hmc):
    kw = dict(_CHUNK, **hmc)
    js = JR.setup_run(JConfig(**kw))
    js, jrec, jfr, jhist, jx, jdiag = JR.run_sampling(js, write_files=False)
    ts = runner.setup_run(RunConfig(**kw), device="cpu")
    ts, trec, tfr, thist, tx, tdiag = runner.run_sampling(ts,
                                                          write_files=False)
    assert int(jdiag) == 0 and tdiag == 0
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert int(tx.sum()) > 0
    for f in ("sweep", "temp", "press", "acc_pos", "acc_vol", "acc_hmc",
              "dpos", "dvol", "dt"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), f)
    for f, tol in (("pe", 1e-5), ("virial", 1e-5), ("vol", 1e-6)):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)), rtol=tol,
                                   err_msg=f)
    if hmc:
        assert float(trec.acc_hmc.max()) > 0
    lmax = float(np.max(np.asarray(jfr[1])))
    np.testing.assert_allclose(tfr[0].numpy(), np.asarray(jfr[0]), rtol=0,
                               atol=1e-5 * lmax)
    np.testing.assert_array_equal(
        ts.states.key.numpy(), np.asarray(jax.random.key_data(js.states.key)))
    assert ts.cellcfg.ncell == js.cellcfg.ncell
    assert ts.cap == js.cap
