"""Port parity: the dense engine's ghost map, energies, pass, volume trial,
sweep and run function against the JAX package, from the same numpy
inputs and jax.random keys (no Pallas on this path).

- ``ghosts.build`` of jittered fcc 4x4x4 (256 atoms, R = 3, shell 2.9):
  every GhostMap field bit for bit; the same for fcc 2x2x2 with a shell
  past half the box (an atom needs more than 7 images: overflow) and with
  a capacity below the images needed (overflow); ``needs_rebuild`` with a
  budget and a shrink, ``apply_moves``, ``scaled`` and ``rewrap_rebuild``
  bit for bit.
- ``delta_moves_dense`` with and without the virial within rtol and atol
  2e-4 of the JAX values; ``total_energy_virial_dense`` within rtol 3e-4
  and atol 1e-2 (pe), 0.1 (virial): the JAX tests' own limits against
  brute force. Under torch's "high" matmul precision the energies are the
  same bits.
- One pass (R = 4, per-replica dpos): every colour's movers bit for bit,
  counters equal, positions within 1e-5 of the box edge, pe within rtol
  1e-5; one volume trial likewise; the legacy sweep function against
  that pass and trial composed as the JAX sweep composes them, its keys
  against jax.random's.
- ``make_dense_run_fn`` with exchange runs in
  tests/test_torch_dense_runner.py, as the JAX runner's dense chunk.

Energies are summed in torch's order (XLA's on the JAX side), so a
decision could part only where its margin is at f32 rounding; on these
seeds none does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu.models.lattice import make_supercell
from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.ops import cells as JC
from neuralmelting_tpu.ops import dense_delta as JDD
from neuralmelting_tpu.ops import ghosts as JG
from neuralmelting_tpu.sampler import dense as JDS
from neuralmelting_tpu.sampler.state import ensemble_init as jax_ensemble
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import cells as C
from neuralmelting_tpu_torch.ops import dense_delta as DD
from neuralmelting_tpu_torch.ops import ghosts as G
from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.parallel import ensemble as ENS
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler import dense as DS
from neuralmelting_tpu_torch.sampler.state import FIELDS, MCState

LAT = 2.0 ** (2.0 / 3.0)
SHELL = 2.9
COUNTERS = ("nap", "ntp", "nav", "ntv", "nah", "nth", "sweep")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jittered(ncells, r, seed, a=1.6, jitter=0.05):
    pos, box = make_supercell("fcc", a, ncells)
    rng = np.random.default_rng(seed)
    ps = [pos + rng.normal(0, jitter, pos.shape) for _ in range(r)]
    ps = np.stack([(p - box * np.floor(p / box)) for p in ps])
    return ps.astype(np.float32), np.tile(np.float32(box), (r, 1))


def _jbuild(pos, box, shell, gcap):
    return jax.jit(jax.vmap(lambda p, b: JG.build(p, b, shell, gcap)))(
        jnp.asarray(pos), jnp.asarray(box))


def _same_map(tg, jg):
    for f in G.FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)


@pytest.fixture(scope="module")
def fcc4():
    """Jittered fcc 4x4x4 (R = 3) and its ghost maps on both sides."""
    pos, box = _jittered(4, 3, 5)
    gcap = G.suggest_gcap(256, box[0], SHELL)
    return dict(pos=pos, box=box, gcap=gcap,
                jg=_jbuild(pos, box, SHELL, gcap),
                tg=G.build(_t(pos), _t(box), SHELL, gcap))


@pytest.mark.parametrize("case", ["fcc4", "rank_overflow", "fits",
                                  "capacity"])
def test_build(fcc4, case):
    if case == "fcc4":
        tg, jg = fcc4["tg"], fcc4["jg"]
        assert not bool(tg.overflow.any()) and int(tg.nghost.min()) > 0
    else:
        # fcc 2x2x2 at a = 1.6 (box 3.2): a shell past half the box needs
        # more than 7 images an atom; capacity 128 holds too few
        pos, box = _jittered(2, 2, 1, jitter=0.0)
        shell, gcap = {"rank_overflow": (1.7, 512), "fits": (1.5, 512),
                       "capacity": (1.5, 128)}[case]
        tg = G.build(_t(pos), _t(box), shell, gcap)
        jg = _jbuild(pos, box, shell, gcap)
        assert bool(tg.overflow.all()) == (case != "fits")
    _same_map(tg, jg)


def test_needs_rebuild_moves_and_rewrap(fcc4):
    jp = JLJ.create()
    jg, tg, box = fcc4["jg"], fcc4["tg"], fcc4["box"]
    # move some atoms (real rows and their ghosts), then check coverage
    rng = np.random.default_rng(7)
    ids = np.stack([rng.choice(256, 9, replace=False) for _ in range(3)])
    delta = rng.uniform(-0.2, 0.2, (3, 9, 3)).astype(np.float32)
    delta[:, 4] = 0.0                               # rejected movers
    jg2 = jax.vmap(lambda g, b, i, d: JG.apply_moves(g, b, i, d))(
        jg, jnp.asarray(box), jnp.asarray(ids, jnp.int32),
        jnp.asarray(delta))
    tg2 = G.apply_moves(tg, _t(ids).int(), _t(delta))
    _same_map(tg2, jg2)
    jstale = jax.jit(jax.vmap(JG.needs_rebuild, in_axes=(0, None, None,
                                                          None)))
    for budget in (0.0, 0.05, 0.1, 0.12, 0.19, 0.25):
        for shrink in (1.0, 0.999, 0.98, 2.5 / 2.9):
            want = jstale(jg2, jp.rc, jnp.float32(budget),
                          jnp.float32(shrink))
            got = G.needs_rebuild(tg2, 2.5, budget=budget, shrink=shrink)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = np.array([0.97, 1.0, 1.02], np.float32)
    _same_map(G.scaled(tg2, _t(s)),
              jax.vmap(JG.scaled)(jg2, jnp.asarray(s)))
    gcap = fcc4["gcap"]
    _same_map(G.rewrap_rebuild(tg2, _t(box), SHELL, gcap),
              jax.jit(jax.vmap(lambda g, b: JG.rewrap_rebuild(
                  g, b, SHELL, gcap)))(jg2, jnp.asarray(box)))


@pytest.mark.parametrize("with_virial", [False, True])
def test_delta_moves(fcc4, with_virial):
    jg, tg, pos = fcc4["jg"], fcc4["tg"], fcc4["pos"]
    ids = np.array([[3, 77, 200], [0, 128, 255], [17, 18, 19]], np.int32)
    disp = np.random.default_rng(2).uniform(-0.15, 0.15, (3, 3, 3)).astype(
        np.float32)
    old = np.take_along_axis(pos, ids[..., None].astype(np.int64), 1)
    want = jax.vmap(lambda g, i, o, n: JDD.delta_moves_dense(
        JLJ.create(), g, i, o, n, with_virial=with_virial))(
        jg, jnp.asarray(ids), jnp.asarray(old), jnp.asarray(old + disp))
    got = DD.delta_moves_dense(LJCut.create(), tg, _t(ids), _t(old),
                               _t(old + disp), with_virial=with_virial)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    if not with_virial:
        assert not got[1].any()


def test_total_and_matmul_precision(fcc4):
    want = jax.vmap(lambda g: JDD.total_energy_virial_dense(
        JLJ.create(), g, 256))(fcc4["jg"])
    pot, tg = LJCut.create(), fcc4["tg"]
    pe, vir = DD.total_energy_virial_dense(pot, tg)
    np.testing.assert_allclose(pe.numpy(), np.asarray(want[0]), rtol=3e-4,
                               atol=1e-2)
    np.testing.assert_allclose(vir.numpy(), np.asarray(want[1]), rtol=3e-4,
                               atol=0.1)
    # blocked rows (with a padded last block) give the same row sums
    pe_b, vir_b = DD.total_energy_virial_dense(pot, tg, row_block=96)
    np.testing.assert_allclose(pe_b.numpy(), pe.numpy(), rtol=1e-6)
    np.testing.assert_allclose(vir_b.numpy(), vir.numpy(), rtol=1e-6)
    # the product never takes a reduced-precision path
    prec = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        pe_h, vir_h = DD.total_energy_virial_dense(pot, tg)
        de_h = DD.delta_moves_dense(pot, tg, _t([[5]] * 3).int(),
                                    tg.pos_ext[:, 5:6], tg.pos_ext[:, 5:6]
                                    + 0.1, with_virial=True)
    finally:
        torch.set_float32_matmul_precision(prec)
    de = DD.delta_moves_dense(pot, tg, _t([[5]] * 3).int(),
                              tg.pos_ext[:, 5:6], tg.pos_ext[:, 5:6] + 0.1,
                              with_virial=True)
    assert torch.equal(pe_h, pe) and torch.equal(vir_h, vir)
    assert torch.equal(de_h[0], de[0]) and torch.equal(de_h[1], de[1])


@pytest.fixture(scope="module")
def ens():
    """The same jittered 256-atom ensemble (R = 4, per-replica dpos) with
    its ghost map (the port's, which test_build holds to the JAX build)
    and its dense energies, as after a record, on both sides."""
    pos, box = make_supercell("fcc", LAT, 4)
    rng = np.random.default_rng(21)
    pos = ((pos + rng.normal(0, 0.04, pos.shape)) % box).astype(np.float32)
    temps = jnp.asarray([0.6, 0.9, 1.2, 1.5], jnp.float32)
    press = jnp.asarray([1.0, 1.0, 3.0, 3.0], jnp.float32)
    jp = JLJ.create()
    js = jax_ensemble(jp, pos, box, 31, temps, press, 0.1, 0.01, 0.005)
    js = js.replace(dpos=jnp.asarray([0.05, 0.08, 0.1, 0.12], jnp.float32))
    gcap = G.suggest_gcap(256, box, SHELL)
    ts = MCState(**{f: _t(getattr(js, f)) for f in FIELDS},
                 key=J.key_data(jax.random.key_data(js.key)))
    tg = DS.build_ensemble_ghosts(ts, SHELL, gcap)
    ts.pe, ts.virial = DD.total_energy_virial_dense(LJCut.create(), tg)
    js = js.replace(pe=jnp.asarray(ts.pe.numpy()),
                    virial=jnp.asarray(ts.virial.numpy()))
    jg = JG.GhostMap(**{f: jnp.asarray(getattr(tg, f).numpy())
                        for f in G.FIELDS})
    jcfg = JC.make_cell_config(box, 2.5, stride=4)
    tcfg = C.make_cell_config(box, 2.5, stride=4)
    return dict(jp=jp, tp=LJCut.create(), js=js, ts=ts, jg=jg, tg=tg,
                jcfg=jcfg, tcfg=tcfg, box=box, gcap=gcap,
                table=ENS.table_tensor(tcfg, "cpu"))


def _copy(tree):
    return jax.tree.map(jnp.copy, tree)


def _close(js, ts, jg, tg, pos_tol, box):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.box.numpy(), np.asarray(js.box), rtol=1e-6)
    np.testing.assert_allclose(tg.pos_ext[:, :256].numpy(),
                               np.asarray(jg.pos_ext)[:, :256], rtol=0,
                               atol=pos_tol * float(np.max(box)))
    for f in ("pe", "virial"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   err_msg=f)


def test_one_pass(ens):
    js, ts, jcfg, tcfg = ens["js"], ens["ts"], ens["jcfg"], ens["tcfg"]
    pkeys = jax.vmap(lambda k: jax.random.fold_in(k, 5))(js.key)
    tkeys = J.fold_in(ts.key, 5)
    c, m = jcfg.ncolors, jcfg.cells_per_color
    # every colour's movers, in colour order, bitwise against the JAX
    # pass's own draws and binning
    shift, u, _, _ = DS.pass_draws(tkeys, c, m, ts.dpos)
    posw = G.wrap(ens["tg"].pos_ext[:, :256], ts.box)
    ids, start, count = C.bin_particles(posw, ts.box, tcfg.ncell, shift)
    got, _ = CB.pick_movers(ens["table"], torch.arange(c).expand(4, -1),
                            count, start, ids, u)
    table = np.asarray(jcfg.active_table)
    for r in range(4):
        ksh, kcol = jax.random.split(pkeys[r], 2)
        jids, jstart, jcount = (np.asarray(a) for a in JC.bin_particles(
            js.pos[r], js.box[r], jcfg.ncell,
            jax.random.uniform(ksh, (3,), jnp.float32)))
        ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            jax.random.split(k, 3)[0], (m,), jnp.float32))(
            jax.random.split(kcol, c)))                        # (C, M)
        cnt = jcount[table]
        pick = np.minimum((ju * cnt).astype(np.int32),
                          np.maximum(cnt - 1, 0))
        want = jids[np.clip(jstart[table] + pick, 0, 255)]
        np.testing.assert_array_equal(got[r].numpy(), want)
    jpass = jax.jit(jax.vmap(JDS.make_dense_pass_fn(1.0, jcfg),
                             in_axes=(None, None, 0, 0, 0, 0)))
    js2, jg2 = jpass(ens["jp"], jnp.asarray(jcfg.active_table), js,
                     _copy(ens["jg"]), js.dpos, pkeys)
    ts2, tg2 = DS.make_dense_pass_fn(1.0, tcfg)(
        ens["tp"], ens["table"], ts, ens["tg"], ts.dpos, tkeys)
    assert int(ts2.nap.sum()) > 0 and int(ts2.ntp.sum()) > int(ts2.nap.sum())
    _close(js2, ts2, jg2, tg2, 1e-5, ens["box"])
    # the input map is not changed
    assert torch.equal(ens["tg"].pos_ext, _t(ens["jg"].pos_ext))


def test_volume_trial(ens):
    js, ts = ens["js"], ens["ts"]
    # a larger step so that trials are both accepted and rejected
    dvol = jnp.asarray([2.0, 4.0, 8.0, 16.0], jnp.float32)
    js = js.replace(dvol=dvol)
    ts = ts.replace(dvol=_t(dvol))
    keys = jax.vmap(lambda k: jax.random.fold_in(k, 9))(js.key)
    jvol = jax.jit(jax.vmap(JDS.make_dense_vol_fn(1.0, 1.0),
                            in_axes=(None, 0, 0, 0)))
    js2, jg2 = jvol(ens["jp"], js, _copy(ens["jg"]), keys)
    ts2, tg2 = DS.make_dense_vol_fn(1.0, 1.0)(ens["tp"], ts, ens["tg"],
                                              J.fold_in(ts.key, 9))
    assert 0 < int(ts2.nav.sum()) < 4
    _close(js2, ts2, jg2, tg2, 1e-6, ens["box"])
    for f in ("ref_box", "shell"):
        np.testing.assert_allclose(getattr(tg2, f).numpy(),
                                   np.asarray(getattr(jg2, f)), rtol=1e-6)


def test_sweep_fn(ens):
    """The legacy sweep: its keys against jax.random's (split in three,
    the pass keys a split, the volume key folded), its diag, and its
    states and map against the pass and volume trial held to JAX above,
    composed as the JAX sweep composes them (dpos clamped to half the
    checkerboard margin and to the shell's room, not at 0)."""
    ts, tg, tcfg = ens["ts"], ens["tg"], ens["tcfg"]
    ts2, tg2, diag = DS.make_dense_sweep_fn(1.0, 1.0, tcfg, npasses=2,
                                            nvol=1)(
        ens["tp"], ens["table"], ts, tg)
    jkeys = jax.vmap(lambda k: jax.random.split(k, 3))(ens["js"].key)
    kd = np.asarray(jax.random.key_data(jkeys))              # (R, 3, 2)
    np.testing.assert_array_equal(ts2.key.numpy(), kd[:, 0])
    pk = np.asarray(jax.random.key_data(jax.vmap(
        lambda k: jax.random.split(k, 2))(jkeys[:, 1])))
    assert int(diag.abs().sum()) == 0
    margin = DS.dense_dpos_margin(ens["tp"], tcfg, ts.box)
    room = torch.clamp(tg.shell - 2.5, min=0.0)
    dpos = torch.minimum(ts.dpos, torch.minimum(
        0.5 * margin, CB.div(room, 2.0 * 3.0 ** 0.5)))
    one_pass = DS.make_dense_pass_fn(1.0, tcfg)
    st, g = ts.replace(key=_t(kd[:, 0])), tg
    for p in range(2):
        st, g = one_pass(ens["tp"], ens["table"], st, g, dpos,
                         _t(pk[:, p]))
    st, g = DS.make_dense_vol_fn(1.0, 1.0)(ens["tp"], st, g,
                                           J.fold_in(_t(kd[:, 2]), 0))
    for f in FIELDS:
        want = getattr(st, f) + (1 if f == "sweep" else 0)
        assert torch.equal(getattr(ts2, f), want), f
    for f in G.FIELDS:
        assert torch.equal(getattr(tg2, f), getattr(g, f)), f
