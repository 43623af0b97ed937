"""Port parity: kernel P1's plain versions against the JAX package's
probe kernel, at the script's REPS and at 8 passes, the variants of group
"div" (tests/test_torch_probe_case.py says how and within what
tolerance)."""

import pytest

from test_torch_probe_case import (  # noqa: F401
    GROUPS, _against_script, inputs, plain_variant_matches_pallas_interpret,
    script, script_reps8)


@pytest.mark.parametrize("variant", GROUPS["div"])
def test_plain_variant_matches_pallas_interpret(script, inputs, variant):
    plain_variant_matches_pallas_interpret(script, inputs, variant)


@pytest.mark.parametrize("variant", GROUPS["div"])
def test_plain_variant_at_other_reps_matches_pallas_interpret(
        script_reps8, inputs, variant):
    _against_script(script_reps8, inputs, variant, reps=8)
