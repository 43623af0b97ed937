"""Port parity: kernel B4 (the full EAM pass), plain PyTorch version.

ops/cellmc_eam.py ``total`` on CPU tensors (its plain version) against the
JAX package's Pallas ``make_eam_total_fn`` in interpret mode, on the same
series and slabs (tests/test_torch_eam_case.py: 256 atoms, cells (3,3,3),
K=16), R=2, once with the virial at s=1 and once energy-only at a different
scale per replica. Tolerances: the stats within relative 1e-5 (f32 sums
over ~3500 pairs in different orders); the density slab within 2e-5
absolute (rho ~ 16 here, f32 ulp 1.9e-6, ~14 terms per atom). The plain
version also meets an independent float64 brute-force energy (relative
1e-5; densities within 1e-4, the f32 recurrence's rounding), and its
virial is -dE/dln s by central difference (1e-3 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu.ops.pallas import cellmc_eam as JCE

import test_torch_eam_case as eam_case
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG

TEMPS = (300.0, 1200.0)
RUNS = {"virial-s1": (True, (1.0, 1.0)),
        "energy-s": (False, (0.99, 1.008))}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jc, tc = eam_case.chebs(eam_case.write_table(
        tmp_path_factory.mktemp("eam")))
    c = eam_case.case(tc, TEMPS, seed=4)
    c.update(jc=jc, tc=tc, port={}, jax={})
    gj = eam_case.jax_geom(c)
    jscal = jnp.asarray(c["scal"].numpy())
    jser = tuple(jnp.asarray(s.numpy()) for s in c["series"])
    for name, (wv, scale) in RUNS.items():
        s = torch.tensor(scale)
        c["port"][name] = CE.total(c["geom"], c["slabs"], c["params"],
                                   c["scal"], c["series"], s, wv)
        tot = JCE.make_eam_total_fn(gj, c["nser"], with_virial=wv,
                                    interpret=True, rt=c["r"])
        st, rho = tot(tuple(eam_case.jt(a) for a in c["slabs"]),
                      eam_case.jt(c["params"]), jscal, jser,
                      jnp.asarray(np.asarray(scale, np.float32)[None]))
        c["jax"][name] = (np.array(st).T, np.array(rho).T)
    return c


@pytest.mark.parametrize("name", list(RUNS))
def test_total_stats_match_jax(case, name):
    t, j = case["port"][name][0].numpy(), case["jax"][name][0]
    assert t.shape == (2, 8)
    wv = RUNS[name][0]
    rows = [0, 1, 2, 3, 5, 6] if wv else [0, 2, 3]
    np.testing.assert_allclose(t[:, rows], j[:, rows], rtol=1e-5)
    zero = [4, 7] if wv else [1, 4, 5, 6, 7]
    assert (t[:, zero] == 0).all() and (j[:, zero] == 0).all()
    assert (t[:, 0] < 0).all()


@pytest.mark.parametrize("name", list(RUNS))
def test_total_rho_slab_matches_jax(case, name):
    t, j = case["port"][name][1].numpy(), case["jax"][name][1]
    ok = case["ids"].numpy() >= 0
    assert np.abs(t - j)[ok].max() < 2e-5
    assert (t[~ok] == 0).all()
    assert 10.0 < t[ok].mean() < 25.0


@pytest.mark.parametrize("name", list(RUNS))
def test_total_matches_brute_force(case, name):
    """E and the per-atom densities of each replica against an O(N^2)
    float64 evaluation of the same series at the scaled positions."""
    st, rho = case["port"][name]
    scale = RUNS[name][1]
    ids = case["ids"].numpy()
    for r in range(2):
        e, rho_b = eam_case.brute(case["tc"], case["pos"][r], case["box"],
                                  scale[r])
        assert abs(float(st[r, 0]) - e) < 1e-5 * abs(e)
        ok = ids[r] >= 0
        # f32 Clenshaw (29 terms) against float64: a few 1e-6 relative
        assert np.abs(rho[r].numpy()[ok] - rho_b[ids[r][ok]]).max() < 1e-4


def test_total_virial_is_minus_dE_dlns(case):
    """W = sum r f = -dE/dln s (the repo's sign), by central difference
    of energy-only passes at s = 1 +- 1e-3."""
    st = case["port"]["virial-s1"][0]
    h = 1e-3
    e = [CE.total(case["geom"], case["slabs"], case["params"], case["scal"],
                  case["series"], torch.full((2,), 1.0 + d), False)[0][:, 0]
         for d in (h, -h)]
    w_fd = ((e[0] - e[1]) / (2 * h)).numpy()
    w = st[:, 1].numpy()
    assert (np.abs(w + w_fd) / np.maximum(1.0, np.abs(w_fd)) < 1e-3).all()
    # the parts: W = -(W_pair' + W_emb')
    np.testing.assert_allclose(w, -(st[:, 5] + st[:, 6]).numpy(), rtol=1e-6)


def test_total_dispatch_has_no_fallback(case):
    """A CPU tensor runs the plain version and counts no launch; the
    kernels refuse the LJ geometry."""
    CE.reset_launches()
    st, _ = CE.total(case["geom"], case["slabs"], case["params"],
                     case["scal"], case["series"], torch.ones(2), False)
    assert CE.LAUNCHES == {"eam_sweep": 0, "eam_total": 0}
    np.testing.assert_array_equal(
        st.numpy(), CE.total_plain(case["geom"], case["slabs"],
                                   case["params"], case["scal"],
                                   case["series"], torch.ones(2),
                                   False)[0].numpy())
    lj = CG.make_geom(case["box"], 3.8, 256, nsub=1, stride=2)
    with pytest.raises(ValueError, match="stride-3"):
        CE.total(lj, case["slabs"], case["params"], case["scal"],
                 case["series"], torch.ones(2), False)
