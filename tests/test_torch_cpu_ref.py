"""The port's loop-based CPU reference (``refimpl/cpu_ref.py``) on
tests/test_golden.py's four cases (32 LJ atoms: cold, hot, step-size
adaptation, HMC), from the same seeds.

(a) Against the JAX package's cpu_ref: after every sweep every counter
    and the key are equal, and positions, box, pe and virial are equal
    bit for bit, but in the HMC case. There the velocities' normal draws
    are not bit for bit (``ops/jrandom.py``: a few f32 ulps on about 1%
    of draws), and after the second sweep positions lie 3.7e-9 and pe
    8.7e-9 apart (measured): held to 1e-7. The step sizes after each
    record's adaptation are equal.
(b) The port's serial engine (``golden.run_chain`` on the CPU) against
    the port's cpu_ref: every attempt's move type and decision equal
    (both traces), and test_golden.py's checks with its tolerances.
"""

import jax
import numpy as np
import pytest
import torch

from neuralmelting_tpu.refimpl import cpu_ref as JREF
from neuralmelting_tpu_torch import golden
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.refimpl import cpu_ref

LAT = 2.0 ** (2.0 / 3.0)
# tests/test_golden.py's run_pair calls
CASES = {
    "cold": dict(temp=0.5, press=1.0, nsweeps=6, mod=3, seed=11),
    "hot": dict(temp=1.2, press=2.0, nsweeps=6, mod=3, seed=5),
    "adapt": dict(temp=0.8, press=1.0, nsweeps=9, mod=3, seed=11),
    "hmc": dict(temp=0.8, press=1.0, nsweeps=2, mod=1, seed=9, ppos=0.7,
                pvol=0.05),
}
COUNTERS = ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")
HMC_ATOL = 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moves(c):
    return c.get("ppos", 0.96875), c.get("pvol", 0.03125)


def _init(mod, c):
    pos, box = make_supercell("fcc", LAT, 2)
    key = jax.random.key(c["seed"]) if mod is JREF else J.key(c["seed"])
    return mod.init_ref_state(pos, box, key, c["temp"], c["press"],
                              dpos0=0.1, dvol_frac0=0.01, dt0=0.005)


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_ref_matches_jax_cpu_ref(case):
    c = CASES[case]
    ppos, pvol = _moves(c)
    js, ts = _init(JREF, c), _init(cpu_ref, c)
    assert ts.pe == js.pe and ts.virial == js.virial and ts.dvol == js.dvol
    tried = np.zeros(3, int)
    for _ in range(c["nsweeps"] // c["mod"]):
        for _ in range(c["mod"]):
            js = JREF.sweep(js, 1.0, 1.0, ppos, pvol, 1.0, 1.0, 2.5,
                            nstps=4)
            ts = cpu_ref.sweep(ts, 1.0, 1.0, ppos, pvol, 1.0, 1.0, 2.5,
                               nstps=4)
            for f in COUNTERS:
                assert getattr(ts, f) == getattr(js, f), (case, f)
            np.testing.assert_array_equal(
                ts.key.numpy(), np.asarray(jax.random.key_data(js.key)))
            if case == "hmc":
                np.testing.assert_allclose(ts.pos, js.pos, rtol=0,
                                           atol=HMC_ATOL)
                np.testing.assert_allclose(ts.box, js.box, rtol=0,
                                           atol=HMC_ATOL)
                assert abs(ts.pe - js.pe) <= HMC_ATOL
            else:
                np.testing.assert_array_equal(ts.pos, js.pos)
                np.testing.assert_array_equal(ts.box, js.box)
                assert (ts.pe, ts.virial) == (js.pe, js.virial)
        tried += (ts.ntp, ts.ntv, ts.nth)
        js, ts = JREF.adapt(js), cpu_ref.adapt(ts)
        assert (ts.dpos, ts.dvol) == (js.dpos, js.dvol)
    assert tried[0] > 0 and tried[1] > 0
    assert (tried[2] > 0) == (case == "hmc")


@pytest.mark.parametrize("case", list(CASES))
def test_serial_chain_matches_cpu_ref(case):
    """tests/test_golden.py's run_pair and checks, both sides the port's."""
    c = CASES[case]
    ppos, pvol = _moves(c)
    nrec = c["nsweeps"] // c["mod"]
    trace, rtrace = [], []
    state, recs, _ = golden.run_chain(
        "cpu", ncells=2, seed=c["seed"], temp=c["temp"], press=c["press"],
        dpos0=0.1, dvol_frac0=0.01, dt0=0.005, ppos=ppos, pvol=pvol,
        nstps=4, mass=1.0, mod=c["mod"], nrecords=nrec, trace=trace)
    ref, ref_recs = cpu_ref.run_records(
        _init(cpu_ref, c), nrec, c["mod"], 1.0, 1.0, ppos, pvol, nstps=4,
        mass=1.0, trace=rtrace)
    assert len(trace) == len(rtrace) == c["nsweeps"]
    for (mtype, acc, _), (rtype, racc) in zip(trace, rtrace):
        np.testing.assert_array_equal(mtype.cpu().numpy(), rtype)
        np.testing.assert_array_equal(acc.cpu().numpy(), racc)
    pos, box, pe = state.pos.numpy(), state.box.numpy(), float(state.pe)
    if case == "cold":
        np.testing.assert_allclose(pos, ref.pos, rtol=0, atol=5e-4)
        np.testing.assert_allclose(box, ref.box, rtol=1e-5)
        np.testing.assert_allclose(pe, ref.pe, rtol=2e-4, atol=5e-3)
        for k, (rpe, vol, *_) in enumerate(ref_recs):
            np.testing.assert_allclose(float(recs.pe[k]), rpe, rtol=2e-4,
                                       atol=5e-3)
            np.testing.assert_allclose(float(recs.vol[k]), vol, rtol=1e-5)
    elif case == "hot":
        np.testing.assert_allclose(pos, ref.pos, rtol=0, atol=2e-3)
        np.testing.assert_allclose(pe, ref.pe, rtol=5e-4, atol=2e-2)
    elif case == "adapt":
        np.testing.assert_allclose(float(state.dpos), ref.dpos, rtol=1e-5)
        np.testing.assert_allclose(float(state.dvol), ref.dvol, rtol=1e-4)
    else:
        np.testing.assert_allclose(pos, ref.pos, rtol=0, atol=1e-2)
        np.testing.assert_allclose(pe, ref.pe, rtol=5e-3)
        np.testing.assert_allclose(box, ref.box, rtol=1e-5)
        assert sum(r[7] for r in ref_recs) > 0, "no HMC trials exercised"
        for k, (_, _, nap, ntp, _, _, nah, nth) in enumerate(ref_recs):
            np.testing.assert_allclose(float(recs.acc_pos[k]),
                                       nap / max(ntp, 1), atol=1e-6)
            np.testing.assert_allclose(float(recs.acc_hmc[k]),
                                       nah / max(nth, 1), atol=1e-6)
