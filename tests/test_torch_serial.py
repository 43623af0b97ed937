"""Port parity: the serial golden engine (BASELINE config 1's path).

(a) Each move type, and whole serial sweeps, against the JAX serial engine
    from the same jax.random key: counters identical after every move or
    sweep, positions and box within 1e-5 relative (positions relative to
    the box edge), pe within rtol 2e-4.
(b) tests/test_golden.py's HMC case against the loop-based CPU reference,
    with that test's tolerances.
(c) Config 1 through driver.make_run_fn against the committed golden files
    tests/golden/config1.* (the JAX package's run, tests/make_golden.py):
    sweep, acc_pos, acc_vol, dpos, dvol equal; pe and virial within rtol
    2e-4 / atol 5e-3, vol within rtol 1e-5 (test_golden.py's tolerances);
    frames within atol 5e-4.
(d) A JAX chain's state carried across with state_from_numpy, key
    included, continuing as the JAX chain does.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax

from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.refimpl import cpu_ref
from neuralmelting_tpu.sampler import driver as JD
from neuralmelting_tpu.sampler import moves as JM
from neuralmelting_tpu.sampler import serial as JS
from neuralmelting_tpu.sampler import state as JST
from neuralmelting_tpu_torch import golden
from neuralmelting_tpu_torch.io import thermo, traj
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.ops import lj_delta as LD
from neuralmelting_tpu_torch.sampler import driver, moves, serial
from neuralmelting_tpu_torch.sampler.state import FIELDS, init_state, \
    state_from_numpy

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
LAT = 2.0 ** (2.0 / 3.0)
COUNTERS = ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")
POS_RTOL = 1e-5
PE_RTOL = 2e-4


def _states(seed, temp, press, dpos0=0.1, dvol_frac0=0.01, dt0=0.005,
            ncells=2):
    pos, box = make_supercell("fcc", LAT, ncells)
    js = JST.init_state(JLJ.create(), pos, box, jax.random.key(seed), temp,
                        press, dpos0=dpos0, dvol_frac0=dvol_frac0, dt0=dt0)
    ts = init_state(LJCut.create(), pos, box, J.key(seed), temp, press,
                    dpos0, dvol_frac0, dt0, device="cpu")
    return js, ts


def _same(js, ts, tag=""):
    for c in COUNTERS:
        assert int(getattr(js, c)) == int(getattr(ts, c)), (tag, c)
    box = np.asarray(js.box)
    np.testing.assert_allclose(ts.box.numpy(), box, rtol=POS_RTOL, atol=0)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=POS_RTOL * box.max())
    np.testing.assert_allclose(float(ts.pe), float(js.pe), rtol=PE_RTOL)
    np.testing.assert_allclose(float(ts.virial), float(js.virial),
                               rtol=PE_RTOL, atol=5e-3)


def test_init_state_matches_jax():
    js, ts = _states(3, 0.8, 2.0, ncells=3)
    _same(js, ts)
    for f in ("temp", "press", "dpos", "dvol", "dt"):
        assert getattr(ts, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(
        ts.key.numpy(), np.asarray(jax.random.key_data(js.key)))


def test_default_device_is_the_card():
    """init_state and golden run on the card unless asked for the CPU;
    without a GPU their defaults raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    pos, box = make_supercell("fcc", LAT, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(LJCut.create(), pos, box, J.key(0), 0.8, 1.0, 0.1, 0.01,
                   0.005)
    with pytest.raises(RuntimeError, match="CUDA"):
        golden.run_chain()


@functools.lru_cache(maxsize=None)
def _jax_move(kind):
    pot, be = JLJ.create(), JM.brute_backend()
    if kind == "position":
        fn = lambda s, k: JM.position_move(pot, 1.0, be, s, k)  # noqa: E731
    elif kind == "volume":
        fn = lambda s, k: JM.volume_move(pot, 1.0, 1.0, be, s, k)  # noqa
    else:
        fn = lambda s, k: JM.hmc_move(pot, 1.0, be, s, k, 4, 1.0)  # noqa
    return jax.jit(fn)


def _port_move(kind, state, key):
    pot, be = LJCut.create(), moves.brute_backend()
    if kind == "position":
        return moves.position_move(pot, 1.0, be, state, key)
    if kind == "volume":
        return moves.volume_move(pot, 1.0, 1.0, be, state, key)
    return moves.hmc_move(pot, 1.0, be, state, key, 4, 1.0)


@pytest.mark.parametrize("kind,nmoves,kw", [
    ("position", 40, dict(temp=0.8, dpos0=0.06)),
    ("position", 40, dict(temp=2.0, dpos0=0.12)),
    ("volume", 12, dict(temp=0.8, dvol_frac0=0.02)),
    ("hmc", 6, dict(temp=0.8, dt0=0.03)),
])
def test_move_matches_jax(kind, nmoves, kw):
    js, ts = _states(21, press=1.0, **kw)
    keys = jax.random.split(jax.random.key(77), nmoves)
    for a in range(nmoves):
        js = _jax_move(kind)(js, keys[a])
        ts = _port_move(kind, ts, J.key_data(jax.random.key_data(keys[a])))
        _same(js, ts, (kind, a))
    tried, acc = {"position": ("ntp", "nap"), "volume": ("ntv", "nav"),
                  "hmc": ("nth", "nah")}[kind]
    assert int(getattr(ts, tried)) == nmoves
    # the step sizes give both decisions
    assert 0 < int(getattr(ts, acc)) < nmoves


@functools.lru_cache(maxsize=None)
def _jax_sweep(ppos, pvol):
    pot = JLJ.create()
    sw = JS.make_sweep_fn(1.0, 1.0, JM.brute_backend(), ppos, pvol, 4, 1.0)
    return jax.jit(lambda s: sw(pot, s))


@pytest.mark.parametrize("temp,press,ppos,pvol,seed", [
    (0.5, 1.0, 0.96875, 0.03125, 11),
    (1.2, 2.0, 0.96875, 0.03125, 5),
    (0.8, 1.0, 0.7, 0.05, 9),
])
def test_sweep_matches_jax(temp, press, ppos, pvol, seed):
    js, ts = _states(seed, temp, press)
    sweep = serial.make_sweep_fn(1.0, 1.0, moves.brute_backend(), ppos, pvol,
                                 4, 1.0)
    pot = LJCut.create()
    for s in range(3):
        js = _jax_sweep(ppos, pvol)(js)
        ts = sweep(pot, ts)
        _same(js, ts, s)
        np.testing.assert_array_equal(ts.key.numpy(),
                                      np.asarray(jax.random.key_data(js.key)))
    if pvol < 0.1:
        assert int(ts.ntv) > 0
    else:
        assert int(ts.nth) > 0


def test_sweep_trace_locates_decisions():
    """The trace holds each attempt's move type, decision and margin
    ln u - ln(weight): accepted exactly where the margin is negative."""
    _, ts = _states(9, 0.8, 1.0)
    trace = []
    sweep = serial.make_sweep_fn(1.0, 1.0, moves.brute_backend(), 0.7, 0.05,
                                 4, 1.0, trace=trace)
    sweep(LJCut.create(), ts)
    (mtype, acc, margin), = trace
    assert mtype.shape == acc.shape == margin.shape == (32,)
    assert torch.equal(acc, margin < 0)
    for t, (na, nt) in enumerate((("nap", "ntp"), ("nav", "ntv"),
                                  ("nah", "nth"))):
        assert int(getattr(ts, nt)) == int((mtype == t).sum())
        assert int(getattr(ts, na)) == int(acc[mtype == t].sum())


def test_hmc_golden_case_against_cpu_reference():
    """tests/test_golden.py's HMC case (32 atoms, ppos 0.7, pvol 0.05,
    seed 9), the port against the loop-based CPU reference."""
    kw = dict(ncells=2, seed=9, temp=0.8, press=1.0, dpos0=0.1,
              dvol_frac0=0.01, dt0=0.005, ppos=0.7, pvol=0.05, nstps=4,
              mass=1.0)
    state, recs, _ = golden.run_chain("cpu", mod=1, nrecords=2, **kw)
    pos, box = make_supercell("fcc", LAT, 2)
    ref = cpu_ref.init_ref_state(pos, box, jax.random.key(9), 0.8, 1.0,
                                 dpos0=0.1, dvol_frac0=0.01, dt0=0.005)
    ref_recs = []
    for _ in range(2):
        ref = cpu_ref.sweep(ref, 1.0, 1.0, 0.7, 0.05, 1.0, 1.0, 2.5,
                            nstps=4, mass=1.0)
        ref_recs.append((ref.nap, ref.ntp, ref.nah, ref.nth))
        ref = cpu_ref.adapt(ref)
    np.testing.assert_allclose(state.pos.numpy(), ref.pos, rtol=0, atol=1e-2)
    np.testing.assert_allclose(float(state.pe), ref.pe, rtol=5e-3)
    np.testing.assert_allclose(state.box.numpy(), ref.box, rtol=1e-5)
    assert sum(r[3] for r in ref_recs) > 0, "no HMC trials exercised"
    for k, (nap, ntp, nah, nth) in enumerate(ref_recs):
        np.testing.assert_allclose(float(recs.acc_pos[k]),
                                   nap / max(ntp, 1), atol=1e-6)
        np.testing.assert_allclose(float(recs.acc_hmc[k]),
                                   nah / max(nth, 1), atol=1e-6)


@pytest.fixture(scope="module")
def config1():
    launches = LD.LAUNCHES["delta"]
    trace = []
    state, recs, frames = golden.run_chain("cpu", trace=trace)
    # CPU tensors take B5's plain version: no kernel launch
    assert LD.LAUNCHES["delta"] == launches
    return state, recs, frames, trace


def test_config1_matches_golden_records(config1):
    _, recs, _, _ = config1
    _, want = thermo.read(os.path.join(GOLDEN, "config1.thrm"))
    assert recs.pe.shape == (4,)
    for c in ("sweep", "acc_pos", "acc_vol", "dpos", "dvol"):
        got = getattr(recs, c).numpy()
        np.testing.assert_array_equal(got, want[c].astype(got.dtype), c)
    for c, rtol, atol in (("pe", 2e-4, 5e-3), ("virial", 2e-4, 5e-3),
                          ("vol", 1e-5, 0.0)):
        np.testing.assert_allclose(getattr(recs, c).numpy(), want[c],
                                   rtol=rtol, atol=atol, err_msg=c)


def test_config1_matches_golden_frames(config1):
    _, recs, frames, trace = config1
    gpos, gbox, gsweep = traj.read(os.path.join(GOLDEN, "config1.traj"))
    assert frames[0].shape == (4, 256, 3) and frames[1].shape == (4, 3)
    np.testing.assert_allclose(frames[0].numpy(), gpos, rtol=0, atol=5e-4)
    np.testing.assert_allclose(frames[1].numpy(), gbox, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(recs.sweep.numpy(), gsweep)
    # 16 sweeps of 256 attempts, position and volume moves only
    assert len(trace) == 16
    mtypes = torch.cat([t[0] for t in trace])
    assert set(mtypes.tolist()) == {serial.POS, serial.VOL}


def test_golden_writer_matches_committed_format(config1, tmp_path):
    """golden.write_files writes the committed files' header and sweeps;
    the values read back are the run's records."""
    _, recs, frames, _ = config1
    golden.write_files(str(tmp_path), recs, frames)
    for name in ("config1.thrm", "config1.traj"):
        got = (tmp_path / name).read_text().splitlines()
        want = open(os.path.join(GOLDEN, name)).read().splitlines()
        assert len(got) == len(want)
        assert got[0] == want[0]
    got = (tmp_path / "config1.thrm").read_text().splitlines()
    want = open(os.path.join(GOLDEN, "config1.thrm")).read().splitlines()
    assert [g for g in got if g.startswith("#")] == \
        [w for w in want if w.startswith("#")]
    _, rows = thermo.read(str(tmp_path / "config1.thrm"))
    for c in thermo.COLUMNS:
        np.testing.assert_array_equal(
            rows[c].astype(np.float32), getattr(recs, c).numpy()
            .astype(np.float32), c)


def test_run_fn_without_trajectory():
    _, ts = _states(4, 0.8, 1.0)
    sweep = serial.make_sweep_fn(1.0, 1.0, moves.brute_backend(), 0.96875,
                                 0.03125, 4, 1.0)
    run = driver.make_run_fn(sweep, kb=1.0, mod=2, nrecords=3,
                             write_traj=False)
    state, recs, frames = run(LJCut.create(), ts)
    assert frames is None
    np.testing.assert_array_equal(recs.sweep.numpy(), [2, 4, 6])
    assert int(state.ntp) == 0          # the last record's window was reset


@pytest.mark.parametrize("before,after", [(1, 2), (2, 1)])
def test_state_carried_from_jax_continues_the_chain(before, after):
    """A JAX serial chain's MCState (key as jax.random.key_data) carried
    into the port continues as the JAX chain does."""
    js, _ = _states(13, 1.0, 1.0)
    jsweep = _jax_sweep(0.96875, 0.03125)
    for _ in range(before):
        js = jsweep(js)
    arrays = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    arrays["key"] = np.asarray(jax.random.key_data(js.key))
    ts, rest = state_from_numpy(arrays)
    assert rest == {} and ts.key.dtype == torch.int64
    sweep = serial.make_sweep_fn(1.0, 1.0, moves.brute_backend(), 0.96875,
                                 0.03125, 4, 1.0)
    for s in range(after):
        js = jsweep(js)
        ts = sweep(LJCut.create(), ts)
        _same(js, ts, s)
    np.testing.assert_array_equal(ts.key.numpy(),
                                  np.asarray(jax.random.key_data(js.key)))


def test_jax_run_fn_and_port_run_fn_agree():
    """driver.make_run_fn on both sides: records of a hot 32-atom chain
    (adaptation included) agree record for record."""
    js, ts = _states(5, 1.2, 2.0)
    jsw = JS.make_sweep_fn(1.0, 1.0, JM.brute_backend(), 0.96875, 0.03125,
                           4, 1.0)
    jrun = JD.make_run_fn(jsw, kb=1.0, mod=2, nrecords=2)
    js, jrecs, jframes = jrun(JLJ.create(), js)
    sweep = serial.make_sweep_fn(1.0, 1.0, moves.brute_backend(), 0.96875,
                                 0.03125, 4, 1.0)
    ts, trecs, tframes = driver.make_run_fn(sweep, kb=1.0, mod=2,
                                            nrecords=2)(LJCut.create(), ts)
    for c in ("sweep", "acc_pos", "acc_vol", "dpos", "dvol", "dt", "ke"):
        np.testing.assert_array_equal(getattr(trecs, c).numpy(),
                                      np.asarray(getattr(jrecs, c)), c)
    np.testing.assert_allclose(trecs.pe.numpy(), np.asarray(jrecs.pe),
                               rtol=PE_RTOL)
    np.testing.assert_allclose(tframes[0].numpy(), np.asarray(jframes[0]),
                               rtol=0, atol=POS_RTOL * float(js.box.max()))
