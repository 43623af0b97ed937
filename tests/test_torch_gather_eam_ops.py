"""Port parity: EAM over neighbour lists (ops/eam_energy.py, the gather
engine's EAM terms) against the JAX package's ``ops.eam_energy``.

The same seeded numpy positions and lists go through both, at R = 2 with
the second replica perturbed, in the JAX tests' two geometries
(tests/test_eam.py): 108 atoms (3^3 fcc Al) on the default synthetic
table (rc 6, lists at rc + 0.3, K = 96), and 256 atoms (4^3) on the
rc 3.8 / rs 3.0 table (lists at rc + 0.4). Tolerances, f32 sums in
torch's order against XLA's (which also contracts the spline's Horner
steps into multiply-adds):

- ``spline_eval_t`` against the JAX ``spline_eval``: within 4 f32 ulps of
  the value's scale; ``spline_vals_t`` equal to its value bit for bit;
- ``rho_sums`` atol 1e-5 of the summed density terms; ``total_energy_virial``
  pe and virial rtol 1e-5 of the summed term magnitudes;
- ``forces`` atol 1e-5 of the largest force, and against
  ``torch.autograd`` of ``total`` (the JAX test's oracle) atol 5e-3;
- ``delta_moves`` dE atol 1e-5 of the summed |terms|, dW = 0, and
  against a full recompute (one mover, fresh lists) within the JAX
  test's 2e-3 / 5e-4;
- ``apply_accept`` against ``rho_sums`` of the moved configuration for
  accepted movers, bit for bit unchanged for refused ones, and bit for
  bit equal to adding the movers one at a time in either order (the
  movers' density changes are disjoint, so the scatter's order cannot
  matter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu.models import eam as JE
from neuralmelting_tpu.models import eam_gen as JG
from neuralmelting_tpu.ops import eam_energy as JEE
from neuralmelting_tpu.ops import neighbors as JNB
from neuralmelting_tpu_torch.models import eam as TE
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import eam_energy as EE
from neuralmelting_tpu_torch.ops import neighbors as NB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module", params=["108_rc6", "256_rc38"])
def case(request, tmp_path_factory):
    """Both sides' potential and lists on two replicas: the lattice with
    a small jitter, and a copy perturbed further."""
    path = str(tmp_path_factory.mktemp("eam") / "al.eam.alloy")
    if request.param == "108_rc6":
        JG.write_setfl(path)
        ncells, skin, cap = 3, 0.3, 96
    else:
        JG.write_setfl(path, rc=3.8, rs=3.0)
        ncells, skin, cap = 4, 0.4, None
    jp = JE.load(path)
    tp = TE.to_device(TE.load(path), "cpu")
    pos0, box = make_supercell("fcc", 4.05, ncells)
    rng = np.random.default_rng(ncells)
    pos = np.stack([(pos0 + rng.normal(0, s, pos0.shape)) % box
                    for s in (0.03, 0.1)]).astype(np.float32)
    box = np.repeat(np.asarray(box, np.float32)[None], 2, 0)
    if cap is None:
        cap = NB.suggest_capacity(pos.shape[1], box[0], tp.rc_host + skin)
    jl = jax.vmap(lambda p, b: JNB.build(p, b, jp.rc + skin, cap))(
        jnp.asarray(pos), jnp.asarray(box))
    tl = NB.build(_t(pos), _t(box), NB.f32_rlist(tp.rc_host, skin), cap)
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    assert not tl.overflow.any()
    return dict(jp=jp, tp=tp, pos=pos, box=box, jl=jl, tl=tl, skin=skin,
                cap=cap)


def _jv(fn, c, *extra):
    """A JAX per-replica function over both replicas."""
    return jax.vmap(lambda p, b, nl, *e: fn(c["jp"], p, b, nl, *e))(
        jnp.asarray(c["pos"]), jnp.asarray(c["box"]), c["jl"], *extra)


def test_spline_eval_matches_jax(case):
    jp, tp = case["jp"], case["tp"]
    x = np.random.default_rng(0).uniform(0.5, jp.rc_host, 4000).astype(
        np.float32)
    for coef, jcoef, dx, jdx in ((tp.rho_coef, jp.rho_coef, tp.dr, jp.dr),
                                 (tp.rphi_coef, jp.rphi_coef, tp.dr, jp.dr),
                                 (tp.f_coef, jp.f_coef, tp.drho, jp.drho)):
        val, der = TE.spline_eval_t(coef, dx, _t(x))
        # the value-only form, several tables located at once, is the
        # same value bit for bit
        v2, v3 = TE.spline_vals_t((coef, coef), dx, _t(x))
        assert torch.equal(v2, val) and torch.equal(v3, val)
        jval, jder = JE.spline_eval(jcoef, jdx, jnp.asarray(x))
        for a, b in ((val, jval), (der, jder)):
            b = np.asarray(b)
            scale = np.abs(b).max()
            assert np.abs(a.numpy() - b).max() <= 4 * 2.0 ** -23 * scale


def test_rho_pe_virial(case):
    tp, tl = case["tp"], case["tl"]
    pos, box = _t(case["pos"]), _t(case["box"])
    rho = EE.rho_sums(tp, pos, box, tl)
    jrho = np.asarray(_jv(JEE.rho_sums, case))
    assert rho.shape == (2, pos.shape[1])
    np.testing.assert_allclose(rho.numpy(), jrho, rtol=0,
                               atol=1e-5 * float(jrho.max()))
    pe, vir = EE.total_energy_virial(tp, pos, box, tl)
    jpe, jvir = (np.asarray(a) for a in _jv(JEE.total_energy_virial, case))
    # summed term magnitudes: the embedding and pair energies, the pair
    # virials
    _, _, _, _, _, phi, _, f_i, _ = EE._pair_terms(tp, pos, box, tl)
    mag_e = f_i.abs().sum(-1) + 0.5 * phi.abs().sum((-2, -1))
    mag_w = EE.virial_scale(tp, pos, box, tl)
    assert (np.abs(pe.numpy() - jpe) <= 1e-5 * mag_e.numpy()).all()
    assert (np.abs(vir.numpy() - jvir) <= 1e-5 * mag_w.numpy()).all()
    assert (pe.numpy() / pos.shape[1] < -2.5).all()
    assert not np.array_equal(pe[0].numpy(), pe[1].numpy())


def test_forces(case):
    tp, tl = case["tp"], case["tl"]
    pos, box = _t(case["pos"]), _t(case["box"])
    f = EE.forces(tp, pos, box, tl)
    jf = np.asarray(_jv(JEE.forces, case))
    np.testing.assert_allclose(f.numpy(), jf, rtol=0,
                               atol=1e-5 * np.abs(jf).max())
    p = pos.clone().requires_grad_(True)
    pe, _ = EE.total_energy_virial(tp, p, box, tl)
    (g,) = torch.autograd.grad(pe.sum(), p)
    np.testing.assert_allclose(f.numpy(), -g.numpy(), rtol=5e-3, atol=5e-3)


def _movers(case, m, seed, step=0.15):
    """m movers a replica, pairwise >= 2 rc + 2 sqrt(3) step apart (one
    mover for the 108-atom box, where 2 rc exceeds half the edge), and
    their displaced positions."""
    rng = np.random.default_rng(seed)
    pos, box = case["pos"], case["box"][0]
    gap = 2 * case["tp"].rc_host + 2 * np.sqrt(3) * step
    ids = []
    for r in range(2):
        chosen = []
        for i in rng.permutation(pos.shape[1]):
            d = pos[r, chosen] - pos[r, i]
            d -= box * np.round(d / box)
            if (np.sqrt((d * d).sum(-1)) >= gap).all():
                chosen.append(i)
            if len(chosen) == m:
                break
        ids.append(chosen)
    ids = np.asarray(ids)
    new = (np.take_along_axis(pos, ids[..., None], 1)
           + rng.uniform(-step, step, ids.shape + (3,))).astype(np.float32)
    return ids, new


def test_delta_moves(case):
    tp, tl = case["tp"], case["tl"]
    pos, box = _t(case["pos"]), _t(case["box"])
    m = 1 if pos.shape[1] == 108 else 2
    ids, new = _movers(case, m, seed=5)
    assert ids.shape == (2, m)
    rho = EE.rho_sums(tp, pos, box, tl)
    de, dw, payload = EE.delta_moves(tp, pos, box, tl, rho, _t(ids).long(),
                                     _t(new))
    assert torch.equal(dw, torch.zeros_like(de))
    jrho = _jv(JEE.rho_sums, case)
    jde, _, _ = _jv(JEE.delta_moves, case, jrho, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(new))
    # the summed |terms|: pair energies old and new, the movers' and the
    # neighbours' embedding energies old and new
    drho_rows, rho_i_new, rows, in_row = payload
    mag = np.zeros((2, m))
    for side in (pos.gather(1, _t(ids).long()[..., None].expand(-1, -1, 3)),
                 _t(new)):
        r, valid, *_ = EE._row_r(tp, pos, box, rows, tl.count.gather(
            1, _t(ids).long()), side)
        rphi, _ = TE.spline_eval_t(tp.rphi_coef, tp.dr, r)
        mag += torch.where(valid, rphi / r, 0.0).abs().sum(-1).numpy()
    rho_j = EE._gather_rows(rho, rows)
    for x in (rho.gather(1, _t(ids).long()), rho_i_new):
        mag += TE.spline_eval_t(tp.f_coef, tp.drho, x)[0].abs().numpy()
    for x in (rho_j, rho_j + drho_rows):
        mag += torch.where(in_row, TE.spline_eval_t(tp.f_coef, tp.drho, x)[0],
                           0.0).abs().sum(-1).numpy()
    assert (np.abs(de.numpy() - np.asarray(jde)) <= 1e-5 * mag).all()
    # against a full recompute, one mover at a time on fresh lists
    rlist = NB.f32_rlist(tp.rc_host, case["skin"])
    pe0, _ = EE.total_energy_virial(tp, pos, box, tl)
    for k in range(m):
        pos2 = pos.clone()
        for r in range(2):
            pos2[r, ids[r, k]] = _t(new[r, k])
        nl2 = NB.build(pos2, box, rlist, tl.capacity)
        pe1, _ = EE.total_energy_virial(tp, pos2, box, nl2)
        d1, _, _ = EE.delta_moves(tp, pos, box, tl, rho,
                                  _t(ids[:, k:k + 1]).long(),
                                  _t(new[:, k:k + 1]))
        np.testing.assert_allclose(d1[:, 0].numpy(), (pe1 - pe0).numpy(),
                                   rtol=2e-3, atol=5e-4)


def test_apply_accept(case):
    tp, tl = case["tp"], case["tl"]
    pos, box = _t(case["pos"]), _t(case["box"])
    m = 1 if pos.shape[1] == 108 else 2
    ids, new = _movers(case, m, seed=9, step=0.1)
    tids = _t(ids).long()
    rho = EE.rho_sums(tp, pos, box, tl)
    _, _, payload = EE.delta_moves(tp, pos, box, tl, rho, tids, _t(new))
    acc = torch.ones((2, m), dtype=torch.bool)
    acc[1, 0] = False
    got = EE.apply_accept(rho, tids, acc, payload)
    # the moved configuration's densities, on the same lists (the skin
    # covers the displacement)
    pos2 = pos.clone()
    for r in range(2):
        for k in range(m):
            if acc[r, k]:
                pos2[r, ids[r, k]] = _t(new[r, k])
    want = EE.rho_sums(tp, pos2, box, tl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5 * float(want.max()))
    if m == 1:
        assert torch.equal(got[1], rho[1])       # refused: untouched
    # the same as the movers applied one at a time, in either order
    for order in (range(m), reversed(range(m))):
        seq = rho
        for k in order:
            part = tuple(p[:, k:k + 1] for p in payload)
            seq = EE.apply_accept(seq, tids[:, k:k + 1], acc[:, k:k + 1],
                                  part)
        assert torch.equal(seq, got)
    jrho = _jv(JEE.rho_sums, case)
    _, _, jpay = _jv(JEE.delta_moves, case, jrho, jnp.asarray(ids, jnp.int32),
                     jnp.asarray(new))
    jgot = jax.vmap(JEE.apply_accept)(jrho, jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(acc.numpy()), jpay)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0,
                               atol=1e-5 * float(want.max()))
