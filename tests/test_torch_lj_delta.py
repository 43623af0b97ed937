"""Port parity: kernel B5's plain version and the brute-force energies.

(a) ops/lj_delta.py::delta_moves_plain against the JAX package's Pallas
    kernel delta_moves_pallas in interpret mode (dE), and against its
    brute-force oracle ops/energy.py::delta_move_brute (dE and dW), at the
    JAX kernel test's shapes (tests/test_pallas_kernel.py) and more.
(b) The port's ops/energy.py and LJCut.pair_e_w against the JAX ones.

Each pair term is computed with the same f32 operations on both sides;
sums over atoms are taken in other orders, so a sum may differ by its
terms' rounding: |port - jax| <= SUM_RTOL * (sum of the terms' magnitudes)
+ SUM_ATOL.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.ops import energy as JE
from neuralmelting_tpu.ops.pallas.lj_kernel import delta_moves_pallas
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.ops import energy as E
from neuralmelting_tpu_torch.ops import lj_delta as LD

SUM_RTOL = 1e-6
SUM_ATOL = 1e-5


def _case(r, ncells, m, seed, lattice=1.6, jitter=0.04, step=0.15):
    """R jittered fcc replicas (numpy, from a seed), M distinct movers
    each, displaced by up to +-step per axis."""
    pos, box = make_supercell("fcc", lattice, ncells)
    n = pos.shape[0]
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + jitter * g.standard_normal(pos.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    ids = np.stack([g.choice(n, m, replace=False)
                    for _ in range(r)]).astype(np.int32)
    old = np.take_along_axis(pos, ids[..., None].astype(np.int64), axis=1)
    new = (old + g.uniform(-step, step, old.shape)).astype(np.float32)
    boxes = np.repeat(np.asarray(box, np.float32)[None], r, 0)
    return pos, boxes, ids, old, new


def _magnitudes(pot, case):
    """(R, M) sums of |e| and |w| over both sides' terms inside rc."""
    pos, box, ids, old, new = (torch.as_tensor(x) for x in case)
    _, rc2, _, _ = pot.f32_consts()
    notself = torch.arange(pos.shape[1])[None, None] != ids[:, :, None]
    se = sw = 0.0
    for r in (old, new):
        d = E.min_image(r[:, :, None] - pos[:, None], box[:, None, None])
        r2 = (d * d).sum(-1)
        ok = notself & (r2 < rc2)
        e, w = pot.pair_e_w(torch.clamp(r2, min=LD.R2_FLOOR))
        se = se + torch.where(ok, e.abs(), 0.0).sum(-1)
        sw = sw + torch.where(ok, w.abs(), 0.0).sum(-1)
    return se.numpy(), sw.numpy()


def _close(got, want, mag):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= SUM_RTOL * mag + SUM_ATOL).all(), (err.max(), mag.min())


CASES = [(1, 4, 4, 0), (2, 3, 2, 1), (3, 3, 5, 2),
         (1, 4, 3, 3, 2.0 ** (2 / 3), 0.03, 0.1)]


@pytest.mark.parametrize("spec", CASES[:3])
def test_plain_matches_pallas_interpret(spec):
    pot = LJCut.create()
    case = _case(*spec)
    de, dw = LD.delta_moves_plain(pot, *(torch.as_tensor(x) for x in case))
    assert de.shape == dw.shape == case[2].shape
    assert de.dtype == dw.dtype == torch.float32
    dj = np.asarray(delta_moves_pallas(JLJ.create(), *map(jnp.asarray, case),
                                       interpret=True))
    _close(de.numpy(), dj, _magnitudes(pot, case)[0])


@pytest.mark.parametrize("spec", CASES)
def test_plain_matches_delta_move_brute(spec):
    pot, jpot = LJCut.create(), JLJ.create()
    case = _case(*spec)
    pos, box, ids, old, new = case
    de, dw = LD.delta_moves_plain(pot, *(torch.as_tensor(x) for x in case))
    se, sw = _magnitudes(pot, case)
    for r in range(ids.shape[0]):
        for k in range(ids.shape[1]):
            je, jw = JE.delta_move_brute(jpot, jnp.asarray(pos[r]),
                                         jnp.asarray(box[r]), int(ids[r, k]),
                                         jnp.asarray(new[r, k]))
            _close(de[r, k], je, se[r, k])
            _close(dw[r, k], jw, sw[r, k])
            # the port's own brute-force oracle too
            pe_, pw_ = E.delta_move_brute(pot, torch.as_tensor(pos[r]),
                                          torch.as_tensor(box[r]),
                                          int(ids[r, k]),
                                          torch.as_tensor(new[r, k]))
            _close(de[r, k], pe_, se[r, k])
            _close(dw[r, k], pw_, sw[r, k])


def test_delta_moves_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing; a device
    with no B5 kernel is refused."""
    pot = LJCut.create()
    case = [torch.as_tensor(x) for x in _case(2, 3, 2, 4)]
    before = LD.LAUNCHES["delta"]
    got = LD.delta_moves(pot, *case)
    want = LD.delta_moves_plain(pot, *case)
    assert LD.LAUNCHES["delta"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no B5 kernel"):
        LD.delta_moves(pot, *(t.to("meta") for t in case))


def test_r2_floor_only_below_1e_4():
    """Two atoms 1e-3 apart: B5's 1e-4 floor on r^2 keeps dE finite, as
    the TPU kernel's does, and equals the unfloored term above it."""
    pot = LJCut.create()
    pos = torch.tensor([[[1.0, 1.0, 1.0], [1.5, 1.0, 1.0],
                         [3.0, 3.0, 3.0]]])
    box = torch.tensor([[6.0, 6.0, 6.0]])
    ids = torch.tensor([[2]], dtype=torch.int32)
    for x, floored in ((1.001, True), (1.3, False)):
        new = torch.tensor([[[x, 1.0, 1.0]]])
        de, _ = LD.delta_moves_plain(pot, pos, box, ids, pos[:, 2:3], new)
        assert torch.isfinite(de).all()
        # the old site is out of range of both atoms
        r2 = ((new[0, 0] - pos[0, :2]) ** 2).sum(-1)
        e, _ = pot.pair_e_w(torch.clamp(r2, min=LD.R2_FLOOR) if floored
                            else r2)
        torch.testing.assert_close(de[0, 0], e.sum(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_e_w_and_consts_bitwise(seed):
    pot, jpot = LJCut.create(), JLJ.create()
    sig2, rc2, e4, w24 = pot.f32_consts()
    assert sig2 == float(jpot.sigma * jpot.sigma)
    assert rc2 == float(jpot.rc * jpot.rc)
    assert e4 == float(4.0 * jpot.eps) and w24 == float(24.0 * jpot.eps)
    r2 = np.random.default_rng(seed).uniform(0.6, 6.25, 4096) \
        .astype(np.float32)
    e, w = pot.pair_e_w(torch.as_tensor(r2))
    je, jw = jpot.pair_e_w(jnp.asarray(r2))
    np.testing.assert_array_equal(e.numpy().view(np.uint32),
                                  np.asarray(je).view(np.uint32))
    np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                  np.asarray(jw).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1])
def test_energy_module_matches_jax(seed):
    """pair_energy_virial, forces, min_image and delta_move_brute on one
    jittered 108-atom crystal."""
    pot, jpot = LJCut.create(), JLJ.create()
    pos, box, ids, old, new = _case(1, 3, 1, 10 + seed, jitter=0.06)
    pos, box = pos[0], box[0]
    tp, tb = torch.as_tensor(pos), torch.as_tensor(box)
    jp, jb = jnp.asarray(pos), jnp.asarray(box)
    d = pos[:, None] - pos[None] + 0.5 * box
    np.testing.assert_array_equal(
        E.min_image(torch.as_tensor(d), tb).numpy(),
        np.asarray(JE.min_image(jnp.asarray(d), jb)))
    pe, vir = E.pair_energy_virial(pot, tp, tb)
    jpe, jvir = JE.pair_energy_virial(jpot, jp, jb)
    assert pe.shape == vir.shape == ()
    np.testing.assert_allclose(float(pe), float(jpe), rtol=1e-6)
    np.testing.assert_allclose(float(vir), float(jvir), rtol=1e-6)
    f = E.forces(pot, tp, tb).numpy()
    jf = np.asarray(JE.forces(jpot, jp, jb))
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-4 * np.abs(jf).max())
    i = int(ids[0, 0])
    de, dw = E.delta_move_brute(pot, tp, tb, torch.tensor(i),
                                torch.as_tensor(new[0, 0]))
    jde, jdw = JE.delta_move_brute(jpot, jp, jb, i, jnp.asarray(new[0, 0]))
    np.testing.assert_allclose(float(de), float(jde), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(dw), float(jdw), rtol=1e-5, atol=1e-4)
