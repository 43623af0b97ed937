"""Port parity: the gather engine's building blocks against the JAX package.

Bitwise, from the same numpy inputs and jax.random keys:
- ``jrandom.permutation`` against ``jax.random.permutation`` for n in
  {8, 27, 64} over 200 keys each (one sort round), n = 2000 (two rounds),
  and batched keys;
- ``ensemble_init(seed=)`` keys against the JAX ``ensemble_init``'s;
- ``make_cell_config`` (grid and colour table) and ``bin_particles``
  (order, start, count) on jittered fcc boxes with random grid shifts;
- ``neighbors.build`` (idx, count, overflow), with a capacity that
  overflows too; ``needs_rebuild`` over budgets and shrinks around the
  trigger, and ``suggest_capacity``.

Within f32 tolerances (the JAX sums run in XLA's order with its
multiply-adds contracted, the port's in torch's order): ``pair_energy_virial``
pe and virial rtol 1e-5 of the summed term magnitudes; ``forces`` atol
1e-5 of the largest force; ``delta_moves`` dE and dW atol 1e-5 of the
summed magnitudes of the mover's terms; ``max_displacement`` within 1e-6.

EAM over lists: ``ops_for_style("eam")`` selects its ops, and they run
on a 256-atom lattice (tests/test_torch_gather_eam_ops.py holds them to
the JAX package function by function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu.models.lattice import make_supercell
from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.ops import cells as JC
from neuralmelting_tpu.ops import neighbors as JNB
from neuralmelting_tpu.sampler.state import ensemble_init as jax_ensemble
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import cells as C
from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.ops import neighbors as NB
from neuralmelting_tpu_torch.ops import potential_ops as PO
from neuralmelting_tpu_torch.sampler.state import ensemble_init

LAT = 2.0 ** (2.0 / 3.0)
SKIN = 0.4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(ncells, r, seed, jitter=0.06, strain=0.03):
    """(pos (R, N, 3), box (R, 3)) f32: jittered, strained fcc replicas."""
    rng = np.random.default_rng(seed)
    pos0, box0 = make_supercell("fcc", LAT, ncells)
    pos, box = [], []
    for _ in range(r):
        s = 1.0 + rng.uniform(-strain, strain, 3)
        b = (box0 * s).astype(np.float32)
        p = (pos0 * s + rng.normal(0, jitter, pos0.shape)) % b
        pos.append(p.astype(np.float32))
        box.append(b)
    return np.stack(pos), np.stack(box)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("n", [8, 27, 64])
def test_permutation_bitwise(n):
    jk = jax.random.split(jax.random.key(n), 200)
    want = np.stack([np.asarray(jax.random.permutation(k, n)) for k in jk])
    got = J.permutation(J.key_data(jax.random.key_data(jk)), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_permutation_two_rounds_and_batched():
    jk = jax.random.split(jax.random.key(5), 6).reshape(2, 3)
    want = np.stack([[np.asarray(jax.random.permutation(k, 2000))
                      for k in row] for row in jk])
    got = J.permutation(J.key_data(jax.random.key_data(jk)), 2000).numpy()
    np.testing.assert_array_equal(got, want)


def test_ensemble_keys():
    pos, box = make_supercell("fcc", LAT, 2)
    temps = np.linspace(0.5, 1.5, 5).astype(np.float32)
    js = jax_ensemble(JLJ.create(), pos, box, 17, jnp.asarray(temps),
                      jnp.ones(5), 0.1, 0.01, 0.005)
    ts = ensemble_init(pos, box, temps, np.ones(5), 0.1, 0.01, 0.005,
                       device="cpu", seed=17)
    np.testing.assert_array_equal(ts.key.numpy(),
                                  np.asarray(jax.random.key_data(js.key)))
    assert ensemble_init(pos, box, temps, np.ones(5), 0.1, 0.01, 0.005,
                         device="cpu").key is None


@pytest.mark.parametrize("ncells,stride", [((3, 3, 3), 4), ((4, 4, 4), 4),
                                           ((8, 4, 4), 2)])
def test_cell_config_and_binning_bitwise(ncells, stride):
    pos, box = _boxes(ncells, 3, seed=sum(ncells) + stride)
    jcfg = JC.make_cell_config(box[0], 2.5, stride=stride)
    tcfg = C.make_cell_config(box[0], 2.5, stride=stride)
    assert tcfg.ncell == jcfg.ncell
    np.testing.assert_array_equal(tcfg.active_table, jcfg.active_table)
    shift = np.random.default_rng(1).random((3, 3)).astype(np.float32)
    shift[0] = 0.0
    order, start, count = C.bin_particles(_t(pos), _t(box), tcfg.ncell,
                                          _t(shift))
    for r in range(3):
        jo, js, jc = JC.bin_particles(jnp.asarray(pos[r]), jnp.asarray(box[r]),
                                      jcfg.ncell, jnp.asarray(shift[r]))
        np.testing.assert_array_equal(order[r].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(start[r].numpy(), np.asarray(js))
        np.testing.assert_array_equal(count[r].numpy(), np.asarray(jc))


def _jax_lists(pos, box, rlist, cap):
    return jax.vmap(lambda p, b: JNB.build(p, b, rlist, cap))(
        jnp.asarray(pos), jnp.asarray(box))


@pytest.mark.parametrize("ncells,cap", [((3, 3, 3), None), ((4, 4, 4), None),
                                        ((3, 3, 3), 40)])
def test_build_bitwise(ncells, cap):
    pos, box = _boxes(ncells, 3, seed=7 + sum(ncells))
    n = pos.shape[1]
    rlist = NB.f32_rlist(2.5, SKIN)
    want_cap = JNB.suggest_capacity(n, box[0], 2.5 + SKIN)
    assert NB.suggest_capacity(n, box[0], 2.5 + SKIN) == want_cap
    cap = cap or want_cap
    jl = _jax_lists(pos, box, JLJ.create().rc + SKIN, cap)
    tl = NB.build(_t(pos), _t(box), rlist, cap, tile=4096)  # several blocks
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count))
    np.testing.assert_array_equal(tl.overflow.numpy(), np.asarray(jl.overflow))
    np.testing.assert_array_equal(tl.rlist.numpy(), np.asarray(jl.rlist))
    assert tl.overflow.any().item() == (cap < tl.count.max().item())


def test_needs_rebuild_bitwise():
    pos, box = _boxes((3, 3, 3), 4, seed=3)
    rlist = NB.f32_rlist(2.5, SKIN)
    jp = JLJ.create()
    jl = _jax_lists(pos, box, jp.rc + SKIN, 48)
    tl = NB.build(_t(pos), _t(box), rlist, 48)
    rng = np.random.default_rng(4)
    verdicts = set()
    for k in range(40):
        step = 0.004 * (k % 20)
        s = np.float32(1.0 + 0.002 * (k // 20))
        p2 = (pos * s + rng.normal(0, step, pos.shape)).astype(np.float32)
        b2 = (box * s).astype(np.float32)
        budget = np.float32(0.02 * (k % 5))
        shrink = np.float32(1.0 - 0.01 * (k % 3))
        want = jax.vmap(lambda nl, p, b: JNB.needs_rebuild(
            nl, p, b, jp.rc, budget=budget, shrink=shrink))(
            jl, jnp.asarray(p2), jnp.asarray(b2))
        got = NB.needs_rebuild(tl, _t(p2), _t(b2), 2.5,
                               budget=_t(np.full(4, budget)), shrink=_t(shrink))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        verdicts |= set(got.tolist())
        dj = jax.vmap(JNB.max_displacement)(jl, jnp.asarray(p2),
                                            jnp.asarray(b2))
        np.testing.assert_allclose(NB.max_displacement(tl, _t(p2), _t(b2)),
                                   np.asarray(dj), rtol=0, atol=1e-6)
    assert verdicts == {False, True}


@pytest.fixture(scope="module")
def listed():
    pos, box = _boxes((4, 4, 4), 2, seed=11)
    cap = NB.suggest_capacity(pos.shape[1], box[0], 2.5 + SKIN)
    jl = _jax_lists(pos, box, JLJ.create().rc + SKIN, cap)
    tl = NB.build(_t(pos), _t(box), NB.f32_rlist(2.5, SKIN), cap)
    return pos, box, jl, tl


def test_pair_energy_virial_and_forces(listed):
    pos, box, jl, tl = listed
    jp, tp = JLJ.create(), LJCut.create()
    je, jw = jax.vmap(lambda p, b, nl: JNB.pair_energy_virial(jp, p, b, nl))(
        jnp.asarray(pos), jnp.asarray(box), jl)
    te, tw = NB.pair_energy_virial(tp, _t(pos), _t(box), tl)
    e, w, *_ = NB._row_terms(tp, _t(pos), _t(box), tl.idx, tl.count,
                             _t(pos))
    mag_e = 0.5 * e.abs().sum(dim=(-2, -1)).numpy()
    mag_w = 0.5 * w.abs().sum(dim=(-2, -1)).numpy()
    assert (np.abs(te.numpy() - np.asarray(je)) <= 1e-5 * mag_e).all()
    assert (np.abs(tw.numpy() - np.asarray(jw)) <= 1e-5 * mag_w).all()
    jf = jax.vmap(lambda p, b, nl: JNB.forces(jp, p, b, nl))(
        jnp.asarray(pos), jnp.asarray(box), jl)
    tf = NB.forces(tp, _t(pos), _t(box), tl).numpy()
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jf)).max())


def test_delta_moves(listed):
    pos, box, jl, tl = listed
    jp, tp = JLJ.create(), LJCut.create()
    rng = np.random.default_rng(2)
    ids = np.stack([rng.choice(pos.shape[1], 9, replace=False)
                    for _ in range(2)])
    new = (np.take_along_axis(pos, ids[..., None], 1)
           + rng.uniform(-0.1, 0.1, (2, 9, 3))).astype(np.float32)
    jde, jdw = jax.vmap(lambda p, b, nl, i, r: JNB.delta_moves(
        jp, p, b, nl, i, r))(jnp.asarray(pos), jnp.asarray(box), jl,
                             jnp.asarray(ids, jnp.int32), jnp.asarray(new))
    tde, tdw = NB.delta_moves(tp, _t(pos), _t(box), tl, _t(ids).long(),
                              _t(new))
    rows = tl.idx.gather(1, _t(ids).long()[..., None].expand(-1, -1,
                                                              tl.capacity))
    cnt = tl.count.gather(1, _t(ids).long())
    mag = [sum(NB._row_terms(tp, _t(pos), _t(box), rows, cnt, _t(c))[k]
               .abs().sum(-1).numpy()
               for c in (np.take_along_axis(pos, ids[..., None], 1), new))
           for k in (0, 1)]
    assert (np.abs(tde.numpy() - np.asarray(jde)) <= 1e-5 * mag[0]).all()
    assert (np.abs(tdw.numpy() - np.asarray(jdw)) <= 1e-5 * mag[1]).all()
    de1, dw1 = NB.delta_move_single(tp, _t(pos), _t(box), tl,
                                    _t(ids[:, 3]).long(), _t(new[:, 3]))
    assert torch.equal(de1, tde[:, 3]) and torch.equal(dw1, tdw[:, 3])


def test_eam_over_lists_runs(tmp_path):
    """EAM over lists is ported: the EAM style selects ``eam_ops``, whose
    entries are ``ops/eam_energy.py``'s and run on the lists (the
    function-by-function parity is tests/test_torch_gather_eam_ops.py);
    LJ keeps ``pair_ops``."""
    from neuralmelting_tpu_torch.models import eam, eam_gen
    from neuralmelting_tpu_torch.ops import eam_energy as EE
    assert PO.ops_for(LJCut.create()) is PO.pair_ops
    assert PO.ops_for_style("eam") is PO.eam_ops
    assert PO.eam_ops.kind == "eam" and PO.eam_ops.range_factor == 2.0
    path = str(tmp_path / "al.eam.alloy")
    eam_gen.write_setfl(path, rc=3.8)
    pot = eam.to_device(eam.load(path), "cpu")
    assert PO.ops_for(pot) is PO.eam_ops
    pos, box = make_supercell("fcc", 4.05, 4)
    pos, box = _t(pos[None].astype(np.float32)), _t(box[None])
    nl = NB.build(pos, box.float(), NB.f32_rlist(3.8, 0.4), 64)
    rho = PO.eam_ops.init_aux(pot, pos, box.float(), nl)
    assert torch.equal(rho, EE.rho_sums(pot, pos, box.float(), nl))
    pe, vir = PO.eam_ops.total(pot, pos, box.float(), nl)
    assert -3.5 < float(pe) / 256 < -2.5 and torch.isfinite(vir).all()
