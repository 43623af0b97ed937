"""Port parity of the coexistence method (neuralmelting_tpu_torch.coexist,
coexist_run) against the JAX package's coexist module and its committed
fast result.

- The six numpy functions give the JAX package's bits on the same seeded
  inputs, one case a seed (the last case's liquid reference freezes and
  its solid reference melts, as in tests/test_coexist.py:87).
- build_coexist_setup at 8x4x4 LJ cells from one numpy liquid: the rows'
  positions equal the JAX functions' composition bit for bit, and each
  replica's pe and virial agree with the JAX package's brute-force energy
  of the same positions within tests/test_torch_total.py's tolerance
  (rtol 1e-5, atol 1e-3).
- coexist_run --fast on the CPU at T* 0.4 and 1.4: the JSON keys of the
  committed coexist_result_fast.json, and its classification.

Sampling runs on one torch thread (the tests share the machine).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmelting_tpu import coexist as JC
from neuralmelting_tpu.models.lattice import make_supercell as j_supercell
from neuralmelting_tpu.models.lj import LJCut as JLJ
from neuralmelting_tpu.ops.energy import pair_energy_virial as j_energy
from neuralmelting_tpu_torch import coexist as TC
from neuralmelting_tpu_torch import coexist_run

ROOT = Path(__file__).resolve().parents[1]
A_LJ = 2.0 ** (2.0 / 3.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _series(rng, nc, ntemp, collapse):
    """(nc, NROWS, ntemp) PE/atom: solid below liquid, a two-phase row
    between them that drifts; ``collapse`` freezes the liquid reference
    at the lowest T and melts the solid one at the highest."""
    s = np.empty((nc, JC.NROWS, ntemp))
    s[:, JC.ROW_SOLID] = -7.0 + 0.01 * rng.standard_normal((nc, ntemp))
    s[:, JC.ROW_LIQUID] = -6.0 + 0.01 * rng.standard_normal((nc, ntemp))
    drift = np.linspace(-0.4, 0.4, ntemp) * np.linspace(0, 1, nc)[:, None]
    s[:, JC.ROW_TWOPHASE] = np.clip(-6.5 + drift, -7.0, -6.0)
    if collapse:
        s[nc // 3:, JC.ROW_LIQUID, 0] = -6.95
        s[nc // 2:, JC.ROW_SOLID, -1] = -6.05
    return s


@pytest.mark.parametrize("seed,collapse", [(0, False), (1, False),
                                           (2, True)])
def test_numpy_functions_equal_jax(seed, collapse):
    rng = np.random.default_rng(seed)
    ntemp, natoms, nc = 5, 64, 8
    box = np.array([4 * A_LJ, 2 * A_LJ, 2 * A_LJ]) * rng.uniform(0.98, 1.02)
    solid, _ = j_supercell("fcc", A_LJ, (2, 2, 2))
    lbox = np.array([2.0, 1.9, 2.1]) * A_LJ * rng.uniform(0.95, 1.05, 3)
    liq = (rng.uniform(-0.5, 1.5, (32, 3)) * lbox).astype(np.float32)
    for fn, args in ((TC.splice_two_phase, (solid, liq, lbox, box)),
                     (TC.tile_liquid, (liq, lbox, box))):
        got = fn(*args)
        want = getattr(JC, fn.__name__)(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    r = JC.NROWS * ntemp
    pe = rng.standard_normal((4, r)) * 10.0 - 400.0
    hist = np.stack([rng.permutation(r) for _ in range(4)])
    np.testing.assert_array_equal(
        TC.row_pe_per_atom(pe, hist, natoms, ntemp),
        JC.row_pe_per_atom(pe, hist, natoms, ntemp))

    temps = np.linspace(0.6, 1.0, ntemp)
    series = _series(rng, nc, ntemp, collapse)
    np.testing.assert_array_equal(TC.liquid_fraction(series[-1]),
                                  JC.liquid_fraction(series[-1]))
    got = TC.classify_series(temps, series)
    want = JC.classify_series(temps, series)
    assert got == want
    if collapse:
        assert got["liquid_ref_froze"][0] and got["solid_ref_melted"][-1]
    x = rng.uniform(-0.2, 1.2, ntemp)
    assert TC.classify_rows(temps, x) == JC.classify_rows(temps, x)


def test_build_coexist_setup_rows_and_energies():
    ncells, temps = (8, 4, 4), (0.7, 0.9)
    rng = np.random.default_rng(5)
    lat, lbox = j_supercell("fcc", A_LJ * 1.04, (4, 4, 4))
    liq = (np.asarray(lat) + 0.12 * rng.standard_normal(lat.shape)).astype(
        np.float32)
    lbox = np.asarray(lbox, np.float32)
    setup = TC.build_coexist_setup("LJ", ncells, temps, 1.0, liq, lbox,
                                   device="cpu")
    pos = setup.states.pos.numpy()
    box0 = setup.states.box[0].numpy()
    solid, jbox = j_supercell("fcc", A_LJ, ncells)
    half, _ = j_supercell("fcc", A_LJ, (4, 4, 4))
    np.testing.assert_array_equal(box0, np.asarray(jbox, np.float32))
    rows = {JC.ROW_SOLID: np.asarray(solid, np.float32),
            JC.ROW_LIQUID: JC.tile_liquid(liq, lbox, box0),
            JC.ROW_TWOPHASE: JC.splice_two_phase(np.asarray(half), liq,
                                                 lbox, box0)}
    nt = len(temps)
    pot = JLJ.create()
    for row, want in rows.items():
        e, w = (float(v) for v in j_energy(pot, jnp.asarray(want),
                                           jnp.asarray(box0)))
        for k in range(row * nt, (row + 1) * nt):
            np.testing.assert_array_equal(pos[k], want)
            np.testing.assert_allclose(float(setup.states.pe[k]), e,
                                       rtol=1e-5, atol=1e-3)
            np.testing.assert_allclose(float(setup.states.virial[k]), w,
                                       rtol=1e-5, atol=1e-3)
    assert setup.states.temp.tolist() == pytest.approx(list(temps) * 3)


def test_coexist_run_fast_classifies_as_committed(tmp_path):
    out = tmp_path / "r.json"
    res = coexist_run.main(["--fast", "--temps", "0.4:1.4:2", "--chunks",
                            "3", "--device", "cpu", "--out", str(out)])
    with open(ROOT / "coexist_result_fast.json") as f:
        ref = json.load(f)
    with open(out) as f:
        written = json.load(f)
    assert sorted(written) == sorted(ref)
    assert sorted(written["result"]) == sorted(ref["result"])
    assert written["tm_bracket"] == res["tm_bracket"]
    assert written["diag"] == 0 and written["device"] == "cpu"
    assert written["natoms"] == ref["natoms"] == 512
    assert written["measured_chunks"] == 3 and written["relax_chunks"] == 1
    r = written["result"]
    assert r["frozen_temps"] == ref["result"]["frozen_temps"] == [0.4]
    assert r["melted_temps"] == ref["result"]["melted_temps"] == [1.4]
    assert r["consistent"] and ref["result"]["consistent"]
    for k in ("solid_ref_melted", "liquid_ref_froze", "liquid_fraction"):
        assert r[k] == ref["result"][k], k
    assert r["bracket"] == [0.4, 1.4]
    assert np.isfinite(written["pe_rows_tail"]).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["r.json"]


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.build_coexist_setup("LJ", (8, 4, 4), (0.7,), 1.0,
                               np.zeros((512, 3), np.float32),
                               np.ones(3, np.float32))
