"""The port runner's cellmc geometry maintenance, counterparts of
tests/test_runner_geom.py:44-86: the kcap hysteresis of
``runner._refresh_cellmc_geom`` (no rebind inside the dead band, growth
near overflow) and ``runner._rebind_cellmc``'s grow-and-retry, which
conserves every atom. On the CPU, at the JAX test's configuration."""

import dataclasses

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.ops import cellmc_geom as CG


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors run fastest on one thread; the tests share the machine
    with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_setup():
    cfg = RunConfig(name="geomtest", element="LJ", ncells=(4, 4, 4),
                    npress=1, ntemp=2, press=(1.0,), temp=(0.8, 1.2),
                    nsmpl=1, mod=2, seed=3, dpos0=0.1, dvol0=0.01)
    return runner.setup_run(cfg, engine="cellmc", device="cpu")


def _count_rebinds(monkeypatch):
    calls = []
    orig = runner._rebind_cellmc

    def spy(setup, geom):
        calls.append(geom)
        return orig(setup, geom)

    monkeypatch.setattr(runner, "_rebind_cellmc", spy)
    return calls


def test_kcap_hysteresis_holds_in_band(small_setup, monkeypatch):
    """Occupancy inside (kcap-16, kcap-4] rebinds nothing."""
    calls = _count_rebinds(monkeypatch)
    g = small_setup.geom
    fake = dataclasses.replace(
        small_setup,
        slab_count=torch.full_like(small_setup.slab_count, g.kcap - 8))
    out = runner._refresh_cellmc_geom(fake)
    assert calls == []
    assert out.geom == g


@pytest.mark.parametrize("near", [2, 3, 0])
def test_kcap_grows_near_overflow(small_setup, monkeypatch, near):
    """Max occupancy within 4 slots of kcap grows the capacity to fit."""
    calls = _count_rebinds(monkeypatch)
    g = small_setup.geom
    count = small_setup.slab_count.clone()
    count[0, 0] = g.kcap - near
    out = runner._refresh_cellmc_geom(
        dataclasses.replace(small_setup, slab_count=count))
    assert len(calls) == 1
    assert out.geom.kcap >= CG.tight_kcap(g.kcap - near, g.nsub)
    assert out.geom.kcap > g.kcap


def test_kcap_shrinks_when_16_below(small_setup, monkeypatch):
    """A tight cap 16 or more below the current one rebinds to it."""
    calls = _count_rebinds(monkeypatch)
    g = dataclasses.replace(small_setup.geom,
                            kcap=small_setup.geom.kcap + 16)
    out = runner._refresh_cellmc_geom(
        dataclasses.replace(small_setup, geom=g))
    assert len(calls) == 1
    assert out.geom.kcap == CG.tight_kcap(
        int(small_setup.slab_count.max()), g.nsub)


def test_rebind_overflow_grows_and_conserves_atoms(small_setup):
    """A rebind into a too-small kcap grows and retries, never dropping
    an atom; energies are refreshed for the new slabs."""
    tiny = dataclasses.replace(small_setup.geom, kcap=8)
    out = runner._rebind_cellmc(small_setup, tiny)
    assert (out.slab_count.sum(dim=1) == small_setup.natoms).all()
    assert int(out.slab_count.max()) <= out.geom.kcap
    assert out.geom.kcap > 8
    ids = out.slabs[3]
    for r in range(ids.shape[0]):
        got = torch.sort(ids[r][ids[r] >= 0]).values
        assert torch.equal(got, torch.arange(small_setup.natoms,
                                             dtype=torch.int32))
    assert np.isfinite(out.states.pe.numpy()).all()
    torch.testing.assert_close(out.states.pe, small_setup.states.pe,
                               rtol=1e-6, atol=0)
