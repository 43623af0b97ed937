"""Port parity: kernel B1 (total pair sums), plain PyTorch version.

ops/cellmc.py ``total`` on CPU tensors (its plain version) against the JAX
package's Pallas ``make_total_fn`` in interpret mode, at the rc=1.5
geometry ((4,4,4) cells, K=16), R=3 with a different scale per replica.
Sums agree to relative 1e-5 (f32, summed in different orders); E, W and
E(s x) agree with the brute-force O(N^2) energy of the JAX package.
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
SCALE = np.asarray([1.0, 0.985, 1.02], np.float32)


@pytest.fixture(scope="module")
def case():
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), 4)
    g = np.random.default_rng(11)
    pos = np.stack([(pos + 0.06 * g.standard_normal(pos.shape)) % box
                    for _ in range(R)]).astype(np.float32)
    boxes = np.repeat(box[None], R, 0).astype(np.float32)
    geom = CG.make_geom(box, RC, pos.shape[1])
    assert geom.ncell == (4, 4, 4) and geom.kcap == 16
    shift = torch.tensor([0.1, 0.4, 0.7])
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos), torch.as_tensor(boxes), shift)
    assert not bool(over)
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = np.concatenate([np.ones((R, 2), np.float32), w, boxes], 1)
    pot3 = np.asarray([1.0, 1.0, RC, 0.0], np.float32)
    t_sums = CK.total(geom, (x, y, z), torch.as_tensor(params),
                      torch.as_tensor(pot3), torch.as_tensor(SCALE))
    gj = CM.make_geom(box, RC, pos.shape[1])
    tot = CM.make_total_fn(gj, interpret=True, rt=R)
    j_sums = tot(tuple(jnp.asarray(a.numpy().T) for a in (x, y, z)),
                 jnp.asarray(params.T), jnp.asarray(pot3),
                 jnp.asarray(SCALE[None, :]))
    return dict(pos=pos, boxes=boxes, t=t_sums.numpy(),
                j=np.array(j_sums).T, geom=geom, x=x, y=y, z=z,
                params=params, pot3=pot3)


def test_total_sums_match_jax(case):
    t, j = case["t"], case["j"]
    assert t.shape == (R, 8)
    np.testing.assert_allclose(t[:, :4], j[:, :4], rtol=1e-5)
    assert (t[:, 4:] == 0).all()
    assert (t[:, :4] > 0).all()


def test_combine_sums_matches_jax(case):
    sums = case["j"]
    e, w, es = CK.combine_sums(torch.as_tensor(sums), 1.0,
                               torch.as_tensor(SCALE))
    je, jw, jes = CM.combine_sums(jnp.asarray(sums.T), 1.0,
                                  jnp.asarray(SCALE))
    for a, b in ((e, je), (w, jw), (es, jes)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("r", range(R))
def test_total_energy_matches_brute_force(case, r):
    e, w, es = CK.combine_sums(torch.as_tensor(case["t"]), 1.0,
                               torch.as_tensor(SCALE))
    pot = JLJ.create(rc=RC)
    pos, box = jnp.asarray(case["pos"][r]), jnp.asarray(case["boxes"][r])
    e0, w0 = EN.pair_energy_virial(pot, pos, box)
    s = float(SCALE[r])
    es0, _ = EN.pair_energy_virial(pot, pos * s, box * s)
    np.testing.assert_allclose(float(e[r]), float(e0), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(w[r]), float(w0), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(es[r]), float(es0), rtol=1e-5,
                               atol=1e-3)


def test_total_dispatch_has_no_fallback(case):
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on a device the kernels do not serve raises."""
    CK.reset_launches()
    CK.total(case["geom"], (case["x"], case["y"], case["z"]),
             torch.as_tensor(case["params"]), torch.as_tensor(case["pot3"]),
             torch.ones(R))
    assert CK.LAUNCHES == {"sweep": 0, "total": 0}
    meta = [a.to("meta") for a in (case["x"], case["y"], case["z"])]
    with pytest.raises(ValueError):
        CK.total(case["geom"], meta, torch.as_tensor(case["params"]),
                 torch.as_tensor(case["pot3"]), torch.ones(R))
