"""Port parity: the plain versions of kernel P1's variants.

neuralmelting_tpu_torch.probe.probe_plain(variant) against the JAX
package's probe kernel, scripts/vpu_probe.py make_kernel(variant), run by
pallas_call in interpret mode on the probe's own (2048, 128) inputs
(REPS 64, and at a second number of passes with the script's REPS
patched on a loaded copy). The plain versions repeat the kernels'
operations in order,
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


@pytest.mark.parametrize("variant", P1.VARIANTS)
def test_plain_variant_matches_pallas_interpret(script, inputs, variant):
    a, b = inputs
    # the default is the script's REPS
    np.testing.assert_array_equal(P1.probe_plain(variant, a, b).numpy(),
                                  P1.probe_plain(variant, a, b,
                                                 reps=P1.REPS).numpy())
    _against_script(script, inputs, variant)


@pytest.fixture(scope="module")
def script_reps8():
    return _script(reps=8)


@pytest.mark.parametrize("variant", P1.VARIANTS)
def test_plain_variant_at_other_reps_matches_pallas_interpret(
        script_reps8, inputs, variant):
    _against_script(script_reps8, inputs, variant, reps=8)


def test_scale_tables():
    """s_i as the script computes it per pass; the bf16 kernels' table
    holds s_i rounded to bf16 in both halves of a word."""
    s = P1.scales(40)
    for i in (0, 1, 39):
        assert s[i] == np.float32(1.0) + np.float32(1e-6) * np.float32(i)
    f32 = P1._scale_table("pair_div", 40, "cpu")
    np.testing.assert_array_equal(f32.numpy(), s)
    bf = P1._scale_table("pair_div_bf16", 40, "cpu").numpy().view(np.uint32)
    want = torch.as_tensor(s).to(torch.bfloat16).view(torch.int16).numpy() \
        .view(np.uint16).astype(np.uint32)
    np.testing.assert_array_equal(bf & 0xFFFF, want)
    np.testing.assert_array_equal(bf >> 16, want)


def test_loop_counts_reads_the_pass_loop():
    """The SASS reader counts the innermost backward-branch loop with the
    most arithmetic: FP32 and bf16x2 operations apart from the rest."""
    sass = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   FADD R2, R2, 1 ;
        /*0020*/              @!P2 BRA `(.L_x_0) ;
.L_x_1:
        /*0030*/                   LDS.64 R2, [R4] ;
        /*0040*/                   FADD R5, R2, -R3 ;
        /*0050*/                   FMUL R6, R5, R5 ;
        /*0060*/                   HFMA2.BF16_V2 R7, R6, R6, -RZ ;
        /*0070*/               @P0 BRA `(.L_x_2) ;
        /*0080*/                   MUFU.RCP R7, R6 ;
.L_x_2:
        /*0090*/                   IADD3 R8, R8, 0x8, RZ ;
        /*00a0*/                   ISETP.GE.AND P1, PT, R8, R9, PT ;
        /*00b0*/                   NOP ;
        /*00c0*/              @!P1 BRA `(.L_x_1) ;
        /*00d0*/                   EXIT ;
.L_x_3:
        /*00e0*/                   BRA `(.L_x_3);
"""
    assert P1.loop_counts(sass) == (4, 5)
