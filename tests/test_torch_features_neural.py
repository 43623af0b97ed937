"""Port parity: g(r), S(q), scalers, classifiers, training and the T_m
fit, against the JAX package on the same inputs (numpy, seeded).

g(r) pair counts must be EQUAL integers (same f32 r^2, same f32 edges,
round-half-even minimum image); everything else agrees to f32 rounding.
Classifier weights are carried over from flax (classifier_params_from_flax)
so both frameworks compute from the same parameters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralmelting_tpu.features import rdf as JR
from neuralmelting_tpu.neural import melt as JM
from neuralmelting_tpu.neural import models as JNM
from neuralmelting_tpu.neural import scalers as JS
from neuralmelting_tpu.neural import train as JTR
from neuralmelting_tpu_torch.features import rdf as TR
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.neural import melt as TM
from neuralmelting_tpu_torch.neural import models as TNM
from neuralmelting_tpu_torch.neural import scalers as TS
from neuralmelting_tpu_torch.neural import train as TTR


def _frames(nf=3, seed=0):
    pos, box = make_supercell("fcc", 1.6, 3)                 # 108 atoms
    g = np.random.default_rng(seed)
    pos = np.stack([pos + 0.08 * g.standard_normal(pos.shape)
                    for _ in range(nf)]).astype(np.float32)
    boxes = np.stack([box * np.float32(1 + 0.01 * i)
                      for i in range(nf)]).astype(np.float32)
    return pos, boxes


@pytest.mark.parametrize("nbins,rmax", [(60, 2.3), (48, 2.0)])
def test_rdf_hist_counts_equal_jax(nbins, rmax):
    pos, boxes = _frames()
    for f in range(pos.shape[0]):
        jg, jc = JR.rdf_hist(jnp.asarray(pos[f]), jnp.asarray(boxes[f]),
                             nbins, rmax)
        tg, tc = TR.rdf_hist(torch.as_tensor(pos[f]),
                             torch.as_tensor(boxes[f]), nbins, rmax)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    assert float(tc.sum()) > 0


def test_rdf_of_uniform_points_counts_equal_jax():
    g = np.random.default_rng(7)
    box = np.asarray([9.0, 10.0, 11.0], np.float32)
    pos = (g.uniform(size=(300, 3)) * box).astype(np.float32)
    jg, jc = JR.rdf_hist(jnp.asarray(pos), jnp.asarray(box), 40, 4.4)
    tg, tc = TR.rdf_hist(torch.as_tensor(pos), torch.as_tensor(box), 40,
                         4.4, max_elems=3000)           # several row blocks
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


def test_rdf_frames_and_structure_factor_match_jax():
    pos, boxes = _frames(4, seed=1)
    jg = np.asarray(JR.rdf_frames(jnp.asarray(pos), jnp.asarray(boxes), 48,
                                  2.3))
    tg = TR.rdf_frames(torch.as_tensor(pos), torch.as_tensor(boxes), 48,
                       2.3, frame_batch=3).numpy()
    np.testing.assert_allclose(tg, jg, rtol=1e-6)
    jq, js = JR.structure_factor(jnp.asarray(jg), jnp.asarray(boxes), 108,
                                 2.3)
    tq, ts = TR.structure_factor(torch.as_tensor(tg), torch.as_tensor(boxes),
                                 108, 2.3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        TR.density(torch.as_tensor(boxes), 108).numpy(),
        np.asarray(JR.density(jnp.asarray(boxes), 108)), rtol=1e-6)


@pytest.mark.parametrize("name", ["minmax", "standard", "robust", "tanh"])
def test_scalers_match_jax(name):
    x = np.random.default_rng(0).normal(3.0, 2.0, (50, 7)).astype(np.float32)
    j = np.asarray(JS.get_scaler(name).fit_transform(jnp.asarray(x)))
    t = TS.get_scaler(name).fit_transform(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def _model_pair(kind, nbins, seed=0):
    jm = JNM.PhaseCNN() if kind == "cnn" else JNM.PhaseMLP()
    tm = TNM.PhaseCNN(nbins) if kind == "cnn" else TNM.PhaseMLP(nbins)
    return jm, tm


def _dataset(npress=2, ntemp=10, nbins=32, seed=0):
    """Synthetic solid/liquid-like g(r) features (as tests/test_neural.py)."""
    rng = np.random.default_rng(seed)
    r = np.linspace(0.05, 3.0, nbins)
    solid = np.exp(-((r - 1.1) ** 2) / 0.003) + 0.7 * np.exp(
        -((r - 1.6) ** 2) / 0.004)
    liquid = 0.8 * np.exp(-((r - 1.15) ** 2) / 0.05)
    feats = np.zeros((npress, ntemp, nbins))
    for p, tmelt in enumerate((4.2, 6.1)[:npress]):
        for t in range(ntemp):
            frac = 1 / (1 + np.exp(-(t - tmelt) / 0.35))
            feats[p, t] = ((1 - frac) * solid + frac * liquid
                           + 0.02 * rng.normal(size=nbins))
    return feats.reshape(-1, nbins).astype(np.float32)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_classifier_logits_from_flax_weights(kind):
    x = _dataset(nbins=64)
    jm, tm = _model_pair(kind, 64)
    params = jm.init(jax.random.key(3), jnp.asarray(x[:1]))
    tm.load_state_dict(TNM.classifier_params_from_flax(
        jax.tree.map(np.asarray, params)))
    jl = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        tl = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_train_classifier_losses_match_jax(kind):
    x = _dataset(nbins=32)
    ntemp, npress = 10, 2
    jmask, jlab = JTR.extreme_t_labels(ntemp, 2)
    tmask, tlab = TTR.extreme_t_labels(ntemp, 2)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    jm, tm = _model_pair(kind, 32)
    key = jax.random.key(11)
    feats = JS.get_scaler("tanh").fit_transform(jnp.asarray(x))
    jres = JTR.train_classifier(jm, feats, jnp.tile(jmask, npress),
                                jnp.tile(jlab, npress), key, epochs=20,
                                lr=3e-3)
    params0 = jm.init(key, feats[:1])       # the JAX run's initial weights
    tm.load_state_dict(TNM.classifier_params_from_flax(
        jax.tree.map(np.asarray, params0)))
    tres = TTR.train_classifier(tm, torch.as_tensor(np.array(feats)),
                                tmask.repeat(npress), tlab.repeat(npress),
                                epochs=20, lr=3e-3)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses),
                               rtol=1e-4)
    np.testing.assert_allclose(tres.probs.numpy(), np.asarray(jres.probs),
                               rtol=1e-4, atol=1e-5)


def test_init_params_are_flax_like():
    m = TNM.PhaseCNN(64)
    TNM.init_params(m, torch.Generator().manual_seed(0))
    w = m.denses[0].weight.detach()
    fan_in = w.shape[1]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566 / np.sqrt(fan_in) + 1e-6
    assert all(float(layer.bias.detach().abs().max()) == 0.0
               for layer in list(m.convs) + list(m.denses))


@pytest.mark.parametrize("tm_true,w_true", [(0.8, 0.05), (1.1, 0.12)])
def test_fit_melting_temperature_matches_jax(tm_true, w_true):
    temps = np.linspace(0.55, 1.45, 12).astype(np.float32)
    noise = np.random.default_rng(1).normal(0, 0.03, 12)
    probs = np.clip(1 / (1 + np.exp(-(temps - tm_true) / w_true)) + noise,
                    0, 1).astype(np.float32)
    jt, jw = JM.fit_melting_temperature(temps, probs)
    tt, tw = TM.fit_melting_temperature(temps, probs)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-4)
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-4)
    grid = np.stack([probs, probs[::-1]])
    tms, _ = TM.melting_curve(temps, grid)
    np.testing.assert_array_equal(TM.crossing_resolved(temps, grid, tms),
                                  JM.crossing_resolved(temps, grid, tms))
