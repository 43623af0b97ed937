"""Port parity: the sweep kernel's threefry stream, bit for bit.

neuralmelting_tpu_torch.ops.rng against the JAX package's in-kernel
generator (threefry2x32, _bits_to_u01, sym16) on the same int32 inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralmelting_tpu.ops.pallas import cellmc as CM
from neuralmelting_tpu_torch.ops import rng


def _jax_sym16(b, sh):
    # the JAX sweep kernel's sym16 (a closure inside its colour step)
    import jax
    v = jax.lax.shift_right_logical(b, sh) & 0xffff
    return (v.astype(jnp.float32) - 32767.5) * (1.0 / 32768.0)


@pytest.mark.parametrize("key,ctr,expect", [
    (0, 0, (0x6b200159, 0x99ba4efe)),
    (-1, -1, (0x1cb996fc, 0xbb002be7)),
])
def test_threefry_known_answers(key, ctr, expect):
    x0, x1 = rng.threefry2x32(key, key, torch.tensor([ctr]),
                              torch.tensor([ctr]))
    assert (int(x0[0]), int(x1[0])) == expect


def _random_words(seed, n=4096):
    g = np.random.default_rng(seed)
    a = g.integers(-2 ** 31, 2 ** 31, size=n, dtype=np.int64)
    # wrap cases: the extremes and their neighbours
    edge = np.asarray([0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1,
                       0x7fffff, 0x800000, 0xffff, 0x10000], np.int64)
    m = min(n, len(edge))
    a[:m] = edge[:m]
    return a.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_threefry_matches_jax(seed):
    k = _random_words(seed + 30, 4)[2:]
    x0 = _random_words(seed + 10)
    x1 = _random_words(seed + 20)
    j0, j1 = CM.threefry2x32(jnp.int32(k[0]), jnp.int32(k[1]),
                             jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = rng.threefry2x32(int(k[0]), int(k[1]), torch.as_tensor(x0),
                              torch.as_tensor(x1))
    np.testing.assert_array_equal(rng.to_int32(t0).numpy(), np.asarray(j0))
    np.testing.assert_array_equal(rng.to_int32(t1).numpy(), np.asarray(j1))


def test_u01_and_sym16_match_jax():
    b = _random_words(3)
    u_j = np.asarray(CM._bits_to_u01(jnp.asarray(b)))
    u_t = rng.bits_to_u01(torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(u_t.view(np.uint32), u_j.view(np.uint32))
    assert u_t.min() > 0.0 and u_t.max() <= 1.0
    for sh in (0, 16):
        s_j = np.asarray(_jax_sym16(jnp.asarray(b), sh))
        s_t = rng.sym16(torch.as_tensor(b), sh).numpy()
        np.testing.assert_array_equal(s_t.view(np.uint32),
                                      s_j.view(np.uint32))
        assert np.abs(s_t).max() < 1.0


def test_to_int32_roundtrip():
    b = _random_words(4)
    w = torch.as_tensor(b).to(torch.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(rng.to_int32(w).numpy(), b)
