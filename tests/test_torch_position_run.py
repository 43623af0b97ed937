"""Port parity: a run of position attempts in one call (kernel B5's run).

(a) ops/lj_delta.py::position_run_plain against a loop of
    sampler/moves.py::position with brute_backend() over the same draws,
    bit for bit: positions, pe, virial, acceptances and weights, on a run
    with accepts, rejects and a wrap across the box.
(b) The serial sweep, which hands each run of consecutive position
    attempts to moves.position_run, against the per-attempt loop it
    replaced (a copy below, _per_attempt_sweep_fn), bit for bit: state,
    key and trace, at config 1's move mix, at a mix with HMC, and on a
    sweep that starts and ends on a volume or HMC attempt and holds a run
    of length 1.
(c) position_run and delta_moves refuse a device that is neither the CPU
    nor CUDA, and wrong dtypes.
(d) One config-1 sweep against the JAX serial engine: counters equal,
    positions within 1e-5 of the box edge, pe within rtol 2e-4 (as
    tests/test_torch_serial.py holds a sweep).
(e) The premise of B5's minimum image (csrc/lj_delta.cu, image): where
    the quotient formed as d (1/b) lies at least 1e-5 from a half-integer
    and below 32 in magnitude, d - b rint(d (1/b)) has the bits of
    d - b rint(d / b), checked in f32 arithmetic on random and adversarial
    displacements.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.sampler import moves as JM
from neuralmelting_tpu.sampler import serial as JS
from neuralmelting_tpu.sampler import state as JST
from neuralmelting_tpu_torch import golden
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.ops import lj_delta as LD
from neuralmelting_tpu_torch.sampler import moves, serial
from neuralmelting_tpu_torch.sampler.state import FIELDS, init_state

LAT = 2.0 ** (2.0 / 3.0)
POS_RTOL = 1e-5
PE_RTOL = 2e-4


def _state(seed=3, temp=0.8, press=1.0, ncells=2, **kw):
    pos, box = make_supercell("fcc", LAT, ncells)
    g = np.random.default_rng(seed)
    pos = (pos + 0.03 * g.standard_normal(pos.shape)) % box
    return init_state(LJCut.create(), pos, box, jrandom.key(seed), temp,
                      press, kw.get("dpos0", 0.1), kw.get("dvol_frac0", 0.01),
                      kw.get("dt0", 0.005), device="cpu")


def _draws(n, a, seed, step):
    """ids (A,) int32, displacements (A, 3) in [-step, step), ln u (A,),
    from numpy."""
    g = np.random.default_rng(seed)
    ids = g.integers(0, n, a).astype(np.int32)
    disp = g.uniform(-step, step, (a, 3)).astype(np.float32)
    lnu = np.log(g.uniform(1e-6, 1.0, a)).astype(np.float32)
    return torch.as_tensor(ids), torch.as_tensor(disp), torch.as_tensor(lnu)


def _assert_bitwise(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                       else a, b.view(torch.int32)
                       if b.dtype == torch.float32 else b), what


def test_run_plain_is_the_per_attempt_loop():
    pot, be = LJCut.create(), moves.brute_backend()
    s_run = _state()
    s_ref = s_run.clone()
    n = s_run.pos.shape[0]
    ids, disp, lnu = _draws(n, 48, 7, 0.25)
    # the atom nearest the origin, moved to just below 0 (and not moved
    # again), wraps to near L
    i0 = int(torch.argmin(s_run.pos.sum(-1)))
    ids[ids == i0] = (i0 + 1) % n
    ids[0] = i0
    disp[0] = -(s_run.pos[i0] + 0.01)
    lnu[0] = -1e30
    nbeta = -(1.0 / (1.0 * s_run.temp))
    acc, w = LD.position_run_plain(pot, s_run.pos, s_run.box, ids, disp,
                                   lnu, nbeta, s_run.pe, s_run.virial)
    want_acc, want_w = [], []
    for k in range(len(ids)):
        ok, wk = moves.position(pot, be, s_ref, nbeta, int(ids[k]), ids[k],
                                disp[k], lnu[k])
        want_acc.append(ok)
        want_w.append(wk)
    assert 0 < int(acc.sum()) < len(ids)
    assert bool(acc[0]) and bool((s_run.pos[i0] > s_run.box - 0.02).all())
    _assert_bitwise(acc, torch.stack(want_acc), "acc")
    _assert_bitwise(w, torch.stack(want_w), "weight")
    for f in ("pos", "pe", "virial"):
        _assert_bitwise(getattr(s_run, f), getattr(s_ref, f), f)
    # the entry point takes the plain version on CPU tensors
    s_api = _state()
    acc2, w2 = LD.position_run(pot, s_api.pos, s_api.box, ids, disp, lnu,
                               nbeta, s_api.pe, s_api.virial)
    _assert_bitwise(acc2, acc, "acc")
    _assert_bitwise(w2, w, "weight")
    _assert_bitwise(s_api.pos, s_run.pos, "pos")


@pytest.mark.parametrize("mtypes,runs", [
    ([0, 0, 0], [(0, 0, 3)]),
    ([1, 0, 0, 2, 0, 1], [(1, 0, 1), (0, 1, 3), (2, 3, 4), (0, 4, 5),
                          (1, 5, 6)]),
    ([1, 1, 0], [(1, 0, 1), (1, 1, 2), (0, 2, 3)]),
    ([2, 2], [(2, 0, 1), (2, 1, 2)]),
])
def test_attempt_runs(mtypes, runs):
    assert serial.attempt_runs(mtypes) == runs


def _per_attempt_sweep_fn(kb, p2e, backend, ppos, pvol, nstps, mass,
                          trace):
    """The serial sweep as it was before position runs: one
    moves.position call per position attempt."""
    t_pos = float(np.float32(ppos))
    t_vol = float(np.float32(ppos + pvol))
    POS, VOL, HMC = serial.POS, serial.VOL, serial.HMC

    def sweep(pot, state):
        n = state.pos.shape[0]
        keys = jrandom.split(state.key, n + 1)
        state.key = keys[0].clone()
        kt, km = jrandom.split(keys[1:], 2).unbind(-2)
        u = jrandom.uniform(kt)
        mtype = torch.where(u < t_pos, POS, torch.where(u < t_vol, VOL, HMC))
        sel = [torch.nonzero(mtype == t).reshape(-1) for t in (POS, VOL, HMC)]
        idx, frac, lnu_p = moves.position_draws(km[sel[POS]], n)
        v2u, lnu_v = moves.volume_draws(km[sel[VOL]])
        normals, lnu_h = moves.hmc_draws(km[sel[HMC]], n)
        disp = moves.displacement(state, frac)
        nbeta = -(1.0 / (kb * state.temp))
        acc = torch.zeros(n, dtype=torch.bool)
        margin = torch.zeros(n, dtype=torch.float32)
        seen = [0, 0, 0]
        for a, t in enumerate(mtype.tolist()):
            j = seen[t]
            seen[t] += 1
            if t == POS:
                lnu = lnu_p[j]
                ok, w = moves.position(pot, backend, state, nbeta,
                                       int(idx[j]), idx[j], disp[j], lnu)
            elif t == VOL:
                lnu = lnu_v[j]
                ok, w = moves.volume(pot, p2e, backend, state, nbeta,
                                     v2u[j], lnu)
            else:
                lnu = lnu_h[j]
                ok, w = moves.hmc(pot, kb, backend, state, nbeta,
                                  normals[j], lnu, nstps, mass)
            acc[a] = ok
            margin[a] = lnu - w
        for t, (na, nt) in enumerate((("nap", "ntp"), ("nav", "ntv"),
                                      ("nah", "nth"))):
            getattr(state, na).add_(((mtype == t) & acc).sum()
                                    .to(torch.int32))
            getattr(state, nt).add_(seen[t])
        state.sweep.add_(1)
        trace.append((mtype, acc, margin))
        return state

    return sweep


def _counting_backend(calls):
    be = moves.brute_backend()

    def position_run(*args):
        calls.append(args[3].shape[0])
        return be.position_run(*args)

    return dataclasses.replace(be, position_run=position_run)


def _run_both(state, ppos, pvol, nsweeps=2, nstps=4):
    pot = LJCut.create()
    calls, tr_run, tr_ref = [], [], []
    s_run, s_ref = state, state.clone()
    sw_run = serial.make_sweep_fn(1.0, 1.0, _counting_backend(calls), ppos,
                                  pvol, nstps, 1.0, trace=tr_run)
    sw_ref = _per_attempt_sweep_fn(1.0, 1.0, moves.brute_backend(), ppos,
                                   pvol, nstps, 1.0, tr_ref)
    for _ in range(nsweeps):
        sw_run(pot, s_run)
        sw_ref(pot, s_ref)
    for f in FIELDS + ("key",):
        a, b = getattr(s_run, f), getattr(s_ref, f)
        _assert_bitwise(a, b, f)
    for (ta, aa, ma), (tb, ab, mb) in zip(tr_run, tr_ref):
        assert torch.equal(ta, tb)
        _assert_bitwise(aa, ab, "acc")
        _assert_bitwise(ma, mb, "margin")
    # one position_run call per run of position attempts
    runs = [r for mt, _, _ in tr_run for r in serial.attempt_runs(mt.tolist())
            if r[0] == serial.POS]
    assert calls == [b - a for _, a, b in runs]
    return tr_run, runs


def test_sweep_config1_mix_matches_per_attempt_loop():
    _, state, _ = golden.setup_chain("cpu")
    tr, runs = _run_both(state, 0.96875, 0.03125, nsweeps=1, nstps=16)
    npos = int((tr[0][0] == serial.POS).sum())
    assert len(runs) < npos and sum(b - a for _, a, b in runs) == npos
    assert int((tr[0][0] == serial.VOL).sum()) > 0


def test_sweep_hmc_mix_matches_per_attempt_loop():
    tr, _ = _run_both(_state(seed=9), 0.7, 0.05)
    mt = torch.cat([t[0] for t in tr])
    assert {serial.POS, serial.VOL, serial.HMC} <= set(mt.tolist())


def test_sweep_edges_match_per_attempt_loop():
    """A sweep that starts and ends on a volume or HMC attempt and holds a
    run of one position attempt: the first such key of a 32-atom chain at
    an even mix."""
    for seed in range(64):
        state = _state(seed=seed)
        trace = []
        serial.make_sweep_fn(1.0, 1.0, moves.brute_backend(), 0.5, 0.3, 4,
                             1.0, trace=trace)(LJCut.create(), state.clone())
        mt = trace[0][0].tolist()
        runs = serial.attempt_runs(mt)
        if mt[0] != serial.POS and mt[-1] != serial.POS and any(
                t == serial.POS and b - a == 1 for t, a, b in runs):
            break
    else:
        pytest.fail("no key of 64 gives the edge cases")
    _run_both(state, 0.5, 0.3, nsweeps=1)


def test_refuses_other_devices_and_dtypes():
    pot = LJCut.create()
    s = _state()
    ids, disp, lnu = _draws(s.pos.shape[0], 4, 1, 0.1)
    nbeta = -(1.0 / s.temp)
    args = [s.pos, s.box, ids, disp, lnu, nbeta, s.pe, s.virial]
    with pytest.raises(ValueError, match="no B5 kernel"):
        LD.position_run(pot, *(t.to("meta") for t in args))
    for k, bad in ((0, s.pos.double()), (2, ids.long()), (3, disp.double()),
                   (4, lnu.double()), (5, nbeta.double())):
        wrong = list(args)
        wrong[k] = bad
        with pytest.raises(ValueError, match="expected"):
            LD.position_run(pot, *wrong)
    old = s.pos[ids.long()][None]
    case = [s.pos[None], s.box[None], ids[None], old, old + disp[None]]
    with pytest.raises(ValueError, match="no B5 kernel"):
        LD.delta_moves(pot, *(t.to("meta") for t in case))
    for k, bad in ((0, case[0].double()), (2, case[2].long()),
                   (4, case[4].double())):
        wrong = list(case)
        wrong[k] = bad
        with pytest.raises(ValueError, match="expected"):
            LD.delta_moves(pot, *wrong)


def test_config1_sweep_matches_jax():
    pos, box = make_supercell("fcc", LAT, 4)
    js = JST.init_state(JLJ.create(), pos, box, jax.random.key(256), 0.8,
                        2.0, dpos0=0.125, dvol_frac0=0.015625, dt0=0.005)
    jsweep = JS.make_sweep_fn(1.0, 1.0, JM.brute_backend(), 0.96875, 0.03125,
                              16, 1.0)
    js = jax.jit(lambda s: jsweep(JLJ.create(), s))(js)
    calls = []
    pot, ts, _ = golden.setup_chain("cpu")
    serial.make_sweep_fn(1.0, 1.0, _counting_backend(calls), 0.96875,
                         0.03125, 16, 1.0)(pot, ts)
    assert 1 < len(calls) < sum(calls) == int(ts.ntp)
    for c in ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep"):
        assert int(getattr(js, c)) == int(getattr(ts, c)), c
    jbox = np.asarray(js.box)
    np.testing.assert_allclose(ts.box.numpy(), jbox, rtol=POS_RTOL, atol=0)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0,
                               atol=POS_RTOL * jbox.max())
    np.testing.assert_allclose(float(ts.pe), float(js.pe), rtol=PE_RTOL)
    np.testing.assert_array_equal(ts.key.numpy(),
                                  np.asarray(jax.random.key_data(js.key)))


@pytest.mark.parametrize("edge", [LAT * 4, LAT * 2, 1.0, 12.7, 25.4])
def test_fast_image_premise(edge):
    f = np.float32
    b = f(edge)
    ib = f(1.0) / b
    g = np.random.default_rng(int(edge * 1000))
    d = [g.uniform(-40.0, 40.0, 100000).astype(np.float32) * b,
         np.array([0.0, -0.0, 1e-30, -1e-30], np.float32)]
    for h in np.arange(-31.5, 32.0, 1.0):
        up = dn = np.array([f(h) * b], np.float32)
        near = [up]
        for _ in range(24):
            up = np.nextafter(up, f(np.inf))
            dn = np.nextafter(dn, f(-np.inf))
            near += [up, dn]
        d.append(np.concatenate(near))
    d = np.concatenate(d).astype(np.float32)
    q = d * ib
    k = np.rint(q)
    fast = (np.abs(q - k) <= f(0.5) - f(1e-5)) & (np.abs(q) < 32.0)
    got = (d - b * k).view(np.int32)
    want = (d - b * np.rint(d / b)).view(np.int32)
    assert fast.mean() > 0.5
    np.testing.assert_array_equal(got[fast], want[fast])
