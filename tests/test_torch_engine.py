"""Port parity and oracles for the cellmc engine layer.

* adapt_step_sizes, make_record, propose_swaps / apply_exchange and
  exchange_event against the JAX package on the same state, the exchange
  fed JAX's own uniforms;
* the ideal-gas oracle through the port's chunk (eps=0 LJ in NPT):
  <V> = (N+1) kT / P within 6%;
* a chunk whose slab overflows retries from the pre-chunk snapshot with
  more slots and keeps every atom.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.sampler import adapt as JA
from neuralmelting_tpu.sampler import driver as JD
from neuralmelting_tpu.sampler import tempering as JT
from neuralmelting_tpu.sampler.state import ensemble_init as jax_init
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.sampler import adapt, driver, tempering
from neuralmelting_tpu_torch.sampler import cellmc as SC
from neuralmelting_tpu_torch.sampler.state import (FIELDS, ensemble_init,
                                                   state_from_numpy)

NP, NT = 2, 3


def _states(seed=0):
    """One random ensemble, as a JAX MCState and as the port's."""
    g = np.random.default_rng(seed)
    r = NP * NT
    pos, box = make_supercell("fcc", 1.6, 2)
    temps = np.tile(np.linspace(0.6, 1.4, NT), NP).astype(np.float32)
    press = np.repeat(np.asarray([1.0, 4.0]), NT).astype(np.float32)
    js = jax_init(JLJ.create(), pos, box, 1, jnp.asarray(temps),
                  jnp.asarray(press), dpos0=0.1, dvol_frac0=0.01, dt0=0.005,
                  energy_fn=lambda p, a, b: (jnp.zeros(()), jnp.zeros(())))
    rnd = dict(
        pe=g.normal(-400, 30, r), virial=g.normal(100, 20, r),
        box=np.asarray(box)[None] * g.uniform(0.97, 1.05, (r, 1)),
        dpos=g.uniform(0.05, 0.2, r), dvol=g.uniform(0.1, 2.0, r),
        dt=g.uniform(0.001, 0.01, r))
    rnd = {k: np.asarray(v, np.float32) for k, v in rnd.items()}
    for f in ("nap", "ntp", "nav", "ntv", "nah", "nth"):
        rnd[f] = g.integers(0, 50, r).astype(np.int32)
    rnd["ntp"][0] = 0                                     # no trials
    rnd["sweep"] = np.full(r, 40, np.int32)
    js = js.replace(**{k: jnp.asarray(v) for k, v in rnd.items()})
    arrays = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    arrays["key"] = np.zeros((r, 2), np.uint32)
    ts, rest = state_from_numpy(arrays)
    assert rest == {}
    return js, ts


def _assert_state_equal(ts, js, rtol=0.0):
    for f in FIELDS:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=f)


def test_adapt_step_sizes_matches_jax():
    js, ts = _states(1)
    targets, factor = (0.4, 0.5, 0.6), 1.0625
    jout = jax.vmap(lambda s: JA.adapt_step_sizes(s, targets, factor))(js)
    tout = adapt.adapt_step_sizes(ts, targets, factor)
    _assert_state_equal(tout, jout, rtol=1e-6)


def test_make_record_matches_jax():
    js, ts = _states(2)
    jrec = jax.vmap(lambda s: JD.make_record(s, 1.0))(js)
    trec = driver.make_record(ts, 1.0)
    for f in dataclasses.fields(driver.ThermoRecord):
        np.testing.assert_allclose(getattr(trec, f.name).numpy(),
                                   np.asarray(getattr(jrec, f.name)),
                                   rtol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("axis,phase", [(1, 0), (1, 1), (0, 0), (0, 1)])
def test_propose_swaps_and_apply_match_jax(axis, phase):
    js, ts = _states(3)
    g = np.random.default_rng(4)
    r = NP * NT
    # energies close enough that some swaps accept and some do not
    e = (np.linspace(-50.0, 50.0, r) + g.normal(0, 30, r)).astype(np.float32)
    v = g.uniform(90, 110, r).astype(np.float32)
    tg = np.tile(np.linspace(0.6, 1.4, NT), NP).astype(np.float32)
    pg = np.repeat(np.asarray([1.0, 4.0]), NT).astype(np.float32)
    key = jax.random.key(10 * axis + phase)
    shape = (NP, NT) if axis == 1 else (NT, NP)
    u = np.array(jax.random.uniform(key, shape, jnp.float32, 1e-38, 1.0))
    jsig, jn = JT.propose_swaps(jnp.asarray(e), jnp.asarray(v),
                                jnp.asarray(tg), jnp.asarray(pg), NP, NT,
                                axis, phase, key, 1.0, 1.0)
    tsig, tn = tempering.propose_swaps(
        torch.as_tensor(e), torch.as_tensor(v), torch.as_tensor(tg),
        torch.as_tensor(pg), NP, NT, axis, phase,
        torch.as_tensor(u.reshape(-1)), 1.0, 1.0)
    np.testing.assert_array_equal(tsig.numpy(), np.asarray(jsig))
    assert int(tn) == int(jn)
    slot_of = np.asarray(g.permutation(r), np.int32)
    jst, jslot = JT.apply_exchange(js, jnp.asarray(slot_of), jsig,
                                   jnp.asarray(tg), jnp.asarray(pg))
    tst, tslot = tempering.apply_exchange(ts, torch.as_tensor(slot_of), tsig,
                                          torch.as_tensor(tg),
                                          torch.as_tensor(pg))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    _assert_state_equal(tst, jst)


def test_exchange_event_matches_jax():
    js, ts = _states(5)
    r = NP * NT
    tg = jnp.asarray(np.tile(np.linspace(0.6, 1.4, NT), NP), jnp.float32)
    pg = jnp.asarray(np.repeat(np.asarray([1.0, 4.0]), NT), jnp.float32)
    jslot = jnp.asarray(np.random.default_rng(6).permutation(r), jnp.int32)
    tslot = torch.as_tensor(np.array(jslot))
    naccs = []
    for event in range(8):
        key = jax.random.key(100 + event)
        axis = (1, 1, 0, 0)[event % 4]
        shape = (NP, NT) if axis == 1 else (NT, NP)
        u = np.array(jax.random.uniform(key, shape, jnp.float32, 1e-38,
                                          1.0)).reshape(-1)
        js, jslot, jn = JT.exchange_event(js, jslot, key, event, NP, NT, tg,
                                          pg, 1.0, 1.0)
        ts, tslot, tn = tempering.exchange_event(
            ts, tslot, torch.as_tensor(u), event, NP, NT,
            torch.as_tensor(np.array(tg)), torch.as_tensor(np.array(pg)),
            1.0, 1.0)
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        assert int(tn) == int(jn)
        naccs.append(int(tn))
        _assert_state_equal(ts, js)
    assert sum(naccs) > 0


def test_cellmc_ideal_gas_mean_volume():
    """eps=0 LJ is an ideal gas: NPT with the V^N Jacobian gives
    <V> = (N+1) kT / P exactly; a wrong Jacobian, P dV term or slab
    rescale shifts this mean."""
    kt, press, n = 2.0, 1.0, 32
    v_expect = (n + 1) * kt / press                  # 66.0
    a = v_expect ** (1.0 / 3.0) / 2.0                # start AT the mean
    pos, box = make_supercell("fcc", a, 2)
    pot = LJCut.create(0.0, 1.0, 1.0)                # eps = 0
    r = 8
    states = ensemble_init(pos, box, [kt] * r, [press] * r, dpos0=0.2,
                           dvol_frac0=0.05, dt0=0.005)
    geom = CG.make_geom(box, pot.rc_host, n, nsub=8)
    shift = torch.zeros(3)
    slabs, count, over = SC.build_slabs(geom, states, shift)
    assert not bool(over)
    states = SC.refresh_energies(geom, states, slabs, pot)
    cell_tabs = torch.as_tensor(CG.geom_tables(geom))
    run = SC.make_cellmc_run_fn(1.0, 1.0, geom, mod=5, nrecords=60, ncyc=1,
                                nvol=2, exchange=False)
    gen = torch.Generator().manual_seed(3)
    out = run(states, slabs, count, shift, pot, cell_tabs, (3, 10), gen)
    states, slabs, count, shift, recs, frames, diag, tried = out
    assert int(diag) == 0
    vols = recs.vol.numpy()                          # (nrec, R)
    assert np.isfinite(vols).all()
    mean_v = vols[10:].mean()                        # burn-in: 10 records
    assert abs(mean_v / v_expect - 1.0) < 0.06, (mean_v, v_expect)
    # attempted moves: 2 volume trials per replica and sweep, plus the
    # position trials
    assert int(tried) > 300 * 2 * r
    assert frames is None


def test_midchunk_overflow_retries_and_keeps_atoms(monkeypatch):
    """A cell outgrowing its slots mid-chunk must grow kcap and rerun the
    chunk from the pre-chunk ensemble. Overflow is forced by a cap equal
    to the current max occupancy, with the pre-chunk maintenance (which
    would grow it first) switched off."""
    cfg = RunConfig(name="geomtest", element="LJ", ncells=(4, 4, 4),
                    npress=1, ntemp=2, press=(1.0,), temp=(0.8, 1.2),
                    nsmpl=1, mod=6, seed=3, dpos0=0.1, dvol0=0.01,
                    rebin_every=1)
    setup = runner.setup_run(cfg, engine="cellmc")
    monkeypatch.setattr(runner, "_refresh_cellmc_geom", lambda s: s)
    mx = int(setup.slab_count.max())
    kc = -(-mx // 8) * 8
    tight = dataclasses.replace(setup.geom, kcap=kc)
    slabs, count, over = SC.build_slabs(tight, setup.states, setup.shift)
    assert not bool(over)
    states = SC.refresh_energies(tight, setup.states, slabs, setup.pot)
    setup = dataclasses.replace(
        setup, geom=tight, slabs=slabs, slab_count=count, states=states,
        cell_tabs=torch.as_tensor(CG.geom_tables(tight)))
    fired = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _chunk in range(8):
            setup, recs, frames, hist, xacc, diag = runner.run_sampling(
                setup, write_traj=False)
            if any("cell slot overflow" in str(w.message) for w in caught):
                fired = True
                break
    assert fired, "overflow retry never fired in 8 chunks"
    assert diag == 0
    assert setup.geom.kcap > kc
    assert (setup.slab_count.sum(dim=1) == setup.natoms).all()
    ids = setup.slabs[3]
    for r in range(ids.shape[0]):
        got = torch.sort(ids[r][ids[r] >= 0]).values
        assert torch.equal(got, torch.arange(setup.natoms, dtype=torch.int32))
    assert torch.isfinite(recs.pe).all()


def test_run_sampling_without_exchange_keeps_slots():
    cfg = RunConfig(name="noex", element="LJ", ncells=(4, 4, 4), npress=1,
                    ntemp=2, press=(1.0,), temp=(0.8, 1.2), nsmpl=2, mod=2,
                    seed=5)
    setup = runner.setup_run(cfg, engine="cellmc")
    setup, recs, frames, hist, xacc, diag = runner.run_sampling(
        setup, exchange=False)
    assert diag == 0
    assert torch.equal(hist, torch.tensor([[0, 1], [0, 1]],
                                          dtype=torch.int32))
    assert int(xacc.abs().sum()) == 0
    assert frames[0].shape == (2, 2, 256, 3) and recs.pe.shape == (2, 2)
    assert (recs.sweep[-1] == 4).all()
    assert int(setup.moves_tried) > 0
