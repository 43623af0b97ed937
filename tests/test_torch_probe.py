"""Port parity: the plain versions of kernel P1's variants.

neuralmelting_tpu_torch.probe.probe_plain(variant) against the JAX
package's probe kernel, scripts/vpu_probe.py make_kernel(variant), run by
pallas_call in interpret mode on the probe's own (2048, 128) inputs
(REPS 64). The plain versions repeat the kernels' operations in order,
with exact reciprocals where the TPU kernels approximate; the script's
kernels run here with pl.reciprocal exact too (in interpret mode its
approx=True is a bf16 reciprocal). The bf16 variants round every
operation to bf16 on both sides and agree bit for bit. In f32, XLA's CPU
backend contracts multiply-adds into FMAs (the port's plain versions, like
its kernels, do not), and e(new) - e(old) cancels, so the f32 variants
agree within |port - jax| <= REL * max |jax|.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from neuralmelting_tpu_torch import probe as P1

REL = 1e-4
SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "scripts", "vpu_probe.py")


def _script():
    spec = importlib.util.spec_from_file_location("vpu_probe_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the kernels' approximate reciprocal made exact, as in the plain
    # versions (make_kernel reads nothing else of pl)
    mod.pl = types.SimpleNamespace(
        reciprocal=lambda x, approx=False: pl.reciprocal(x))
    return mod


@pytest.fixture(scope="module")
def script():
    return _script()


@pytest.fixture(scope="module")
def inputs():
    return P1.inputs("cpu")


def test_shapes_and_variants_match_the_script(script):
    assert (P1.ROWS, P1.LANES, P1.REPS) == (script.ROWS, script.LANES,
                                            script.REPS)
    assert set(P1.OPS) == set(P1.VARIANTS)
    a, b = P1.inputs("cpu")
    np.testing.assert_array_equal(a.numpy(), np.random.RandomState(0).uniform(
        1.0, 2.0, (P1.ROWS, P1.LANES)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        P1.probe("div", a, b)


@pytest.mark.parametrize("variant", P1.VARIANTS)
def test_plain_variant_matches_pallas_interpret(script, inputs, variant):
    a, b = inputs
    dt = P1.dtype_of(variant)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    fn = pl.pallas_call(
        script.make_kernel(variant),
        out_shape=jax.ShapeDtypeStruct((P1.ROWS, P1.LANES), jnp.float32),
        interpret=True)
    want = np.asarray(jax.jit(fn)(jnp.asarray(a.numpy()).astype(jdt),
                                  jnp.asarray(b.numpy()).astype(jdt)))
    got = P1.probe_plain(variant, a, b)
    assert got.dtype == torch.float32 and got.shape == (P1.ROWS, P1.LANES)
    got = got.numpy()
    assert np.isfinite(got).all()
    if dt == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got.astype(np.float64) - want)
    assert err.max() <= REL * np.abs(want).max(), (err.max(),
                                                   np.abs(want).max())
