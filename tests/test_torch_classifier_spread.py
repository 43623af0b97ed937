"""``classifier_spread``: the north star's T_m(P*=1) over classifier
initial weights, on the CPU at the ``--fast`` grid (4 x 8 slots).

Synthetic solid-like and liquid-like g(r) rows with a crossing inside the
grid, saved as a run saves them (two ``feat_NNN.npz``): the features are
the mean over the files; each seed's training gives a T_m inside the grid,
the list repeats, and seed 3's training equals the north star's own
(``northstar.train_and_fit``); the CLI prints the list with its mean and
sd; a state without features raises.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import classifier_spread as CS
from neuralmelting_tpu_torch import northstar as NS
from neuralmelting_tpu_torch.config import grids


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    d = tmp_path_factory.mktemp("ns")
    cfg = NS.make_cfg(fast=True)
    _, temp = grids(cfg)
    r = np.linspace(0.05, 3.0, NS.NBINS)
    solid = np.exp(-((r - 1.1) ** 2) / 0.003) + 0.7 * np.exp(
        -((r - 1.6) ** 2) / 0.004)
    liquid = 0.8 * np.exp(-((r - 1.15) ** 2) / 0.05)
    rng = np.random.default_rng(0)
    saved = []
    for i in range(2):
        g = []
        for p in range(cfg.npress):
            for t in temp:
                frac = 1 / (1 + np.exp(-(t - (0.9 + 0.05 * p)) / 0.05))
                g.append((1 - frac) * solid + frac * liquid
                         + 0.02 * rng.normal(size=NS.NBINS))
        saved.append(np.asarray(g, np.float32))
        np.savez(d / f"feat_{i:03d}.npz", g=saved[-1],
                 box=np.ones((len(g), 3)))
    return str(d), cfg, temp, np.mean(saved, axis=0)


def test_trainings_repeat_and_match_the_recipe(state):
    path, cfg, temp, mean = state
    g, box = NS.saved_features(path, NS.schedule(fast=True)["samp_chunks"])
    assert g.shape == (cfg.npress * len(temp), NS.NBINS)
    assert np.array_equal(g, mean)
    tms = CS.trainings(g, cfg, range(2, 4), "cpu")
    assert tms == CS.trainings(g, cfg, range(2, 4), "cpu")
    assert all(temp[0] < v < temp[-1] for v in tms)
    own = NS.train_and_fit(SimpleNamespace(temp=temp),
                           torch.as_tensor(g, dtype=torch.float32),
                           torch.as_tensor(box), cfg.npress, len(temp),
                           256, 3.0)[0]
    assert float(own[0]) == tms[1]


def test_cli_prints_the_spread(state, capsys, tmp_path):
    out = CS.main([state[0], "--seeds", "0:3", "--fast", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and len(out["tm_p1"]) == 3
    assert out["mean"] == pytest.approx(np.mean(out["tm_p1"]))
    assert out["sd"] == pytest.approx(np.std(out["tm_p1"], ddof=1))
    with pytest.raises(FileNotFoundError):
        CS.main([str(tmp_path), "--fast", "--device", "cpu"])
