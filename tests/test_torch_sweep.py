"""Port parity: kernel B2 (the position sweep), plain PyTorch version.

ops/cellmc.py ``sweep`` on CPU tensors (its plain version) against the JAX
package's Pallas ``make_sweep_fn`` in interpret mode, one cycle (8 colour
steps) at the rc=1.5 geometry ((4,4,4) cells, K=16, J=8), R=3 with
rt=2: two replica tiles with their own threefry keys, the second one
lane-padded by the JAX wrapper.

The draws are the same bits, so every accept decision must be the same:
n_try exact, n_acc equal, positions equal to 1e-6 (a flipped decision
moves an atom by ~dpos). dE is summed in another order (f32), so the
tracked energy change agrees to 1e-4, and the repo's pe identity holds
against the brute-force O(N^2) energy. A flip reports the mover and its
Metropolis margin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.ops import energy as EN
from neuralmelting_tpu.ops.pallas import cellmc as CM
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.ops import cellmc as CK
from neuralmelting_tpu_torch.ops import cellmc_geom as CG

RC = 1.5
R = 3
RT = 2
TEMPS = np.asarray([0.7, 1.0, 1.6], np.float32)
DPOS = np.asarray([0.12, 0.2, 0.3], np.float32)
SEEDS = np.asarray([[1234, 77], [-5, 2 ** 31 - 1]], np.int32)


@pytest.fixture(scope="module")
def case():
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), 4)
    g = np.random.default_rng(5)
    pos = np.stack([(pos + 0.05 * g.standard_normal(pos.shape)) % box
                    for _ in range(R)]).astype(np.float32)
    boxes = np.repeat(box[None], R, 0).astype(np.float32)
    # J=8 movers per cell: the interpret-mode resolve costs O(J^2) traced
    # ops (J=16 takes ~70 s there)
    geom = CG.make_geom(box, RC, pos.shape[1], nsub=8)
    assert geom.ncell == (4, 4, 4) and geom.kcap == 16
    shift = torch.tensor([0.3, 0.05, 0.55])
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes), shift)
    assert not bool(over)
    x0, y0, z0 = x.clone(), y.clone(), z.clone()
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = np.concatenate([(1.0 / TEMPS)[:, None], DPOS[:, None], w,
                             boxes], 1).astype(np.float32)
    pot3 = np.asarray([1.0, 1.0, RC, 0.0], np.float32)
    trace = []
    t_stats = CK.sweep_plain(geom, 1, RT, (x, y, z), count,
                             torch.as_tensor(params), torch.as_tensor(pot3),
                             torch.as_tensor(SEEDS), trace=trace)
    gj = CM.make_geom(box, RC, pos.shape[1], nsub=8)
    sw = CM.make_sweep_fn(gj, ncyc=1, interpret=True, rt=RT)
    (jx, jy, jz), j_stats = sw(
        tuple(jnp.asarray(a.numpy().T) for a in (x0, y0, z0)),
        jnp.asarray(count.numpy().T), jnp.asarray(params.T),
        jnp.asarray(pot3), jnp.asarray(SEEDS))
    return dict(geom=geom, pos=pos, boxes=boxes, shift=shift, ids=ids,
                count=count, t=(x, y, z), j=tuple(np.array(a).T for a in
                                                (jx, jy, jz)),
                t_stats=t_stats.numpy(), j_stats=np.array(j_stats).T,
                trace=trace, x0=(x0, y0, z0))


def _flips(case):
    """Movers whose final slot differs between the two runs, with their
    Metropolis margin ln_u - threshold in the plain run."""
    geom = case["geom"]
    diff = np.zeros((R, geom.rows), bool)
    for a, b in zip(case["t"], case["j"]):
        diff |= np.abs(a.numpy() - b) > 1e-6
        diff &= case["ids"].numpy() >= 0
    out = []
    for tr in case["trace"]:
        cells = np.arange(tr["color"] * geom.cw, (tr["color"] + 1) * geom.cw)
        rows = cells[None, None, :] * geom.kcap + tr["pick"].numpy()
        for r, ji, c in zip(*np.nonzero(tr["valid"].numpy())):
            if diff[r, rows[r, ji, c]]:
                out.append(dict(step=tr["step"], replica=int(r), mover=int(ji),
                                cell=int(cells[c]),
                                margin=float(tr["ln_u"][r, ji, c]
                                             - tr["thr"][r, ji, c])))
    return out


def test_sweep_decisions_match_jax(case):
    t, j = case["t_stats"], case["j_stats"]
    np.testing.assert_array_equal(t[:, 2], j[:, 2])          # n_try exact
    assert (t[:, 2] > 0).all()
    flips = _flips(case)
    assert not flips, f"accept decisions differ (near ties?): {flips}"
    np.testing.assert_array_equal(t[:, 1], j[:, 1])          # n_acc
    assert (t[:, 1] > 0).all() and (t[:, 1] <= t[:, 2]).all()


def test_sweep_positions_and_energy_match_jax(case):
    valid = case["ids"].numpy() >= 0
    for a, b in zip(case["t"], case["j"]):
        np.testing.assert_allclose(a.numpy()[valid], b[valid], rtol=0,
                                   atol=1e-6)
        assert (a.numpy()[~valid] == CG.INVALID).all()
    np.testing.assert_allclose(case["t_stats"][:, 0], case["j_stats"][:, 0],
                               rtol=0, atol=1e-4)
    assert (case["t_stats"][:, 3:] == 0).all()


@pytest.mark.parametrize("r", range(R))
def test_sweep_pe_identity_and_confinement(case, r):
    geom = case["geom"]
    boxes = torch.as_tensor(case["boxes"])
    pot = JLJ.create(rc=RC)
    after = CG.unbin(geom, case["t"] + (case["ids"],), boxes, case["shift"])
    before = CG.unbin(geom, case["x0"] + (case["ids"],), boxes,
                      case["shift"])
    e1, _ = EN.pair_energy_virial(pot, jnp.asarray(after[r].numpy()),
                                  jnp.asarray(case["boxes"][r]))
    e0, _ = EN.pair_energy_virial(pot, jnp.asarray(before[r].numpy()),
                                  jnp.asarray(case["boxes"][r]))
    tracked = float(case["t_stats"][r, 0])
    true = float(e1 - e0)
    assert abs(tracked - true) < 5e-3 + 1e-4 * abs(true), (tracked, true)
    tabs = CG.geom_tables(geom)
    w = case["boxes"][r] / np.asarray(geom.ncell, np.float32)
    valid = case["ids"][r].numpy() >= 0
    for a, c in enumerate(case["t"]):
        cr = c[r].numpy()
        lo = (tabs[a] * w[a]).astype(np.float32)
        assert not (valid & ((cr < lo) | (cr >= lo + w[a]))).any()
