"""Port parity: the jax.random stream of the serial engine's host draws.

neuralmelting_tpu_torch.ops.jrandom against jax.random itself (threefry2x32
keys, jax_threefry_partitionable) over seeds and shapes: keys, split,
fold_in, 32-bit bits, uniform and randint bit for bit; normal within the
few f32 ulps that its erfinv's log1p leaves (jrandom's docstring). Also the
volume move's f64 cube root against jnp.cbrt on the ratios a volume move
meets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.sampler import moves

SEEDS = [0, 7, 256, 2 ** 31 + 11]
SHAPES = [(), (3,), (4, 5), (7, 3, 2)]
# normal: at most this many f32 ulps from jax.random.normal, on at most
# this share of draws (XLA's log1p against torch's, inside erfinv)
NORMAL_ULPS = 3
NORMAL_SHARE = 0.02
# the f64 cube root against jnp.cbrt: at most one ulp apart, on at most
# this share of the ratios
CBRT_SHARE = 0.005


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = jax.random.key(seed), J.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    np.testing.assert_array_equal(J.key_data(jax.random.key_data(jk)).numpy(),
                                  _words(jk))
    for n in (2, 5, 257):
        np.testing.assert_array_equal(J.split(tk, n).numpy(),
                                      _words(jax.random.split(jk, n)))
    for d in (0, 1, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(J.fold_in(tk, d).numpy(),
                                      _words(jax.random.fold_in(jk, d)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_bits_uniform_randint(seed, shape):
    jk, tk = jax.random.key(seed), J.key(seed)
    jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(J.random_bits(tk, shape).numpy(), jb)
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    tu = J.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))
    for lo, hi in ((0, 256), (3, 1000), (-5, 7)):
        ji = np.asarray(jax.random.randint(jk, shape, lo, hi))
        ti = J.randint(tk, shape, lo, hi)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), ji)


@pytest.mark.parametrize("lo,hi", [(-0.3, 0.7), (-0.13, 0.13),
                                   (1e-38, 1.0), (0.3, 2.7)])
def test_uniform_minval_maxval(lo, hi):
    """Bitwise over 2e5 draws, for Python bounds and for f32 tensor bounds
    (the position move's traced -dpos, dpos)."""
    jk, tk = jax.random.key(11), J.key(11)
    ju = np.asarray(jax.random.uniform(jk, (200000,), jnp.float32, lo, hi))
    np.testing.assert_array_equal(
        J.uniform(tk, (200000,), lo, hi).numpy().view(np.uint32),
        ju.view(np.uint32))
    f = np.float32
    lo32, hi32 = f(lo), f(hi)
    jt = np.asarray(jax.jit(lambda k, a, b: jax.random.uniform(
        k, (20000,), jnp.float32, a, b))(jk, lo32, hi32))
    tt = J.uniform(tk, (20000,), torch.tensor(lo32), torch.tensor(hi32))
    np.testing.assert_array_equal(tt.numpy().view(np.uint32),
                                  jt.view(np.uint32))


def test_batched_keys_match_vmap():
    """Leading key axes batch, as jax.vmap over keys does."""
    jk = jax.random.split(jax.random.key(3), 4)
    tk = J.split(J.key(3), 4)
    np.testing.assert_array_equal(
        J.split(tk, 3).numpy(),
        _words(jax.vmap(lambda k: jax.random.split(k, 3))(jk)))
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (2,), jnp.float32, 1e-38, 1.0))(jk))
    np.testing.assert_array_equal(
        J.uniform(tk, (2,), 1e-38, 1.0).numpy().view(np.uint32),
        ju.view(np.uint32))
    ji = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 32))(jk))
    np.testing.assert_array_equal(J.randint(tk, (), 0, 32).numpy(), ji)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_stated_ulps(seed):
    jn = np.asarray(jax.random.normal(jax.random.key(seed), (100000,)))
    tn = J.normal(J.key(seed), (100000,)).numpy()
    d = _ulps(jn, tn)
    assert d.max() <= NORMAL_ULPS, d.max()
    assert (d > 0).mean() <= NORMAL_SHARE, (d > 0).mean()
    # the HMC move's draw: (N, 3) per key, batched over keys
    jk = jax.random.split(jax.random.key(seed), 8)
    jv = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (32, 3)))(jk))
    tv = J.normal(J.split(J.key(seed), 8), (32, 3)).numpy()
    assert _ulps(jv, tv).max() <= NORMAL_ULPS


def test_erfinv_polynomial_tracks_xla():
    """XLA's f32 erfinv polynomial: within 2 ulps of jax's erfinv on the
    normal draw's inputs, and bitwise at 0 and +-inf at +-1."""
    u = J.uniform(J.key(5), (200000,), J._NORMAL_LO, 1.0)
    je = np.asarray(jax.scipy.special.erfinv(jnp.asarray(u.numpy())))
    assert _ulps(je, J.erfinv(u).numpy()).max() <= 2
    x = torch.tensor([0.0, 1.0, -1.0])
    np.testing.assert_array_equal(J.erfinv(x).numpy(), [0.0, np.inf, -np.inf])


def test_cube_root_against_jnp_cbrt():
    """The volume move's cube root (f64, rounded once to f32) against
    jnp.cbrt on every f32 ratio V'/V in [0.98, 1.02], the range config 1's
    volume steps (dvol/V ~ 1.6%) reach."""
    lo = np.float32(0.98).view(np.int32)
    hi = np.float32(1.02).view(np.int32)
    ratios = np.arange(lo, hi, dtype=np.int32).view(np.float32)
    jc = np.asarray(jnp.cbrt(jnp.asarray(ratios)))
    tc = moves.cbrt(torch.as_tensor(ratios)).numpy()
    d = _ulps(jc, tc)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= CBRT_SHARE, (d > 0).mean()
    # f64 rounding is the correctly rounded cube root
    np.testing.assert_array_equal(
        tc, np.cbrt(ratios.astype(np.float64)).astype(np.float32))
