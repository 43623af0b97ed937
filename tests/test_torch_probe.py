"""Port parity: the plain versions of kernel P1's variants.

neuralmelting_tpu_torch.probe.probe_plain(variant) against the JAX
package's probe kernel, scripts/vpu_probe.py make_kernel(variant), run by
pallas_call in interpret mode (tests/test_torch_probe_case.py says how and
within what tolerance). Here: the probe's shapes and variants against the
script's, and the scale tables and SASS reader. Each variant's cases, at
the script's REPS and at a second number of passes (the script's REPS
patched on a loaded copy), are split by variant over
tests/test_torch_probe_{pairs,div,other}.py.
"""

import numpy as np
import pytest
import torch

from neuralmelting_tpu_torch import probe as P1
from test_torch_probe_case import GROUPS, script  # noqa: F401


def test_shapes_and_variants_match_the_script(script):
    assert (P1.ROWS, P1.LANES, P1.REPS) == (script.ROWS, script.LANES,
                                            script.REPS)
    assert set(P1.OPS) == set(P1.VARIANTS)
    # every variant's cases run in exactly one of the split files
    assert sorted(sum(GROUPS.values(), ())) == sorted(P1.VARIANTS)
    a, b = P1.inputs("cpu")
    np.testing.assert_array_equal(a.numpy(), np.random.RandomState(0).uniform(
        1.0, 2.0, (P1.ROWS, P1.LANES)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        P1.probe("div", a, b)


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
