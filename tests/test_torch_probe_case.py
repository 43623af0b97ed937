"""Helpers shared by the port's P1 parity tests (test_torch_probe*.py);
this module holds no tests.

neuralmelting_tpu_torch.probe.probe_plain(variant) is held against the
JAX package's probe kernel, scripts/vpu_probe.py make_kernel(variant),
run by pallas_call in interpret mode on the probe's own (2048, 128)
inputs. The plain versions repeat the kernels' operations in order, with
exact reciprocals where the TPU kernels approximate; the script's kernels
run here with pl.reciprocal exact too (in interpret mode its approx=True
is a bf16 reciprocal). The bf16 variants round every operation to bf16 on
both sides and agree bit for bit. In f32, XLA's CPU backend contracts
multiply-adds into FMAs (the port's plain versions, like its kernels, do
not), and e(new) - e(old) cancels, so the f32 variants agree within
|port - jax| <= REL * max |jax|.

The REPS-64 comparisons take 40-140 s a variant in the parallel suite, so
they are split by name over three files (``GROUPS``) that pytest-xdist's
``--dist loadfile`` runs on separate workers, each variant's case at 8
passes beside it; every variant is in exactly one group
(test_torch_probe.py checks it). xdist queues files by their number of
tests, most first, so the pair keeps these files early in the queue.
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

# the REPS-64 cases by file, of about equal time in interpret mode
GROUPS = {
    "pairs": ("pair_incr", "pair_recip", "fma_peak_bf16"),
    "div": ("pair_div", "div", "recip", "fma_peak"),
    "other": ("pair_div_bf16", "rsqrt", "recip0", "nodiv"),
}


def _script(reps=None):
    spec = importlib.util.spec_from_file_location("vpu_probe_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the kernels' approximate reciprocal made exact, as in the plain
    # versions (make_kernel reads nothing else of pl)
    mod.pl = types.SimpleNamespace(
        reciprocal=lambda x, approx=False: pl.reciprocal(x))
    if reps is not None:
        mod.REPS = reps         # make_kernel's fori_loop reads it
    return mod


@pytest.fixture(scope="module")
def script():
    return _script()


@pytest.fixture(scope="module")
def script_reps8():
    return _script(reps=8)


@pytest.fixture(scope="module")
def inputs():
    return P1.inputs("cpu")


def _against_script(script, inputs, variant, reps=P1.REPS):
    a, b = inputs
    dt = P1.dtype_of(variant)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    fn = pl.pallas_call(
        script.make_kernel(variant),
        out_shape=jax.ShapeDtypeStruct((P1.ROWS, P1.LANES), jnp.float32),
        interpret=True)
    want = np.asarray(jax.jit(fn)(jnp.asarray(a.numpy()).astype(jdt),
                                  jnp.asarray(b.numpy()).astype(jdt)))
    got = P1.probe_plain(variant, a, b, reps=reps)
    assert got.dtype == torch.float32 and got.shape == (P1.ROWS, P1.LANES)
    got = got.numpy()
    assert np.isfinite(got).all()
    if dt == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got.astype(np.float64) - want)
    assert err.max() <= REL * np.abs(want).max(), (err.max(),
                                                   np.abs(want).max())


def plain_variant_matches_pallas_interpret(script, inputs, variant):
    """The REPS-64 case of one variant: the default number of passes is
    the script's REPS, and the plain version agrees with the kernel."""
    a, b = inputs
    np.testing.assert_array_equal(P1.probe_plain(variant, a, b).numpy(),
                                  P1.probe_plain(variant, a, b,
                                                 reps=P1.REPS).numpy())
    _against_script(script, inputs, variant)
