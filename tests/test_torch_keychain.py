"""Port parity: the cellmc engines' host draws (sampler/cellmc.py
``chain_key``, ``chunk_draws``, ``exchange_draws``) against the JAX
engines' ``jax.random`` key chain (neuralmelting_tpu/sampler/cellmc.py),
on the same seeds, for LJ without exchange (key(0)), LJ with it (key(1))
and EAM (key(2)), with and without a shard index folded into the volume
key.

Bit for bit: each volume trial's ``u``, the uniform under its ``ln_u``,
the rebin shift ``du`` and the exchange uniforms. ``ln_u`` itself is
torch's ``log`` of that uniform, within 1 f32 ulp of XLA's ``log``; the
volume scale ``pow(x, 1/3)`` is within 1 ulp of ``jnp.cbrt`` on the
scales these draws give.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neuralmelting_tpu_torch.ops import jrandom
from neuralmelting_tpu_torch.sampler import cellmc as SC

S, NVOL, R = 5, 2, 6
NPRESS, NTEMP = 2, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _jax_chain(base, seed0, sweep0, shard):
    """The JAX engines' draws, as sampler/cellmc.py makes them per sweep."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(base),
                                                np.int32(seed0[0])),
                             np.int32(sweep0))
    us, uas, dus = [], [], []
    for _ in range(S):
        key, kvol, kreb = jax.random.split(key, 3)
        if shard is not None:
            kvol = jax.random.fold_in(kvol, shard)
        row_u, row_a = [], []
        for v in range(NVOL):
            ku, ka = jax.random.split(jax.random.fold_in(kvol, v))
            row_u.append(np.asarray(jax.random.uniform(ku, (R,),
                                                       jnp.float32)))
            row_a.append(np.asarray(jax.random.uniform(
                ka, (R,), jnp.float32, 1e-38, 1.0)))
        us.append(row_u)
        uas.append(row_a)
        dus.append(np.asarray(jax.random.uniform(kreb, (), jnp.float32)))
    return np.asarray(us), np.asarray(uas), np.asarray(dus)


@pytest.mark.parametrize("style,exchange", [("pair", False), ("pair", True),
                                            ("eam", False), ("eam", True)])
@pytest.mark.parametrize("shard", [None, 1])
def test_chunk_draws_are_the_jax_chain(style, exchange, shard):
    base = SC.CHAIN_BASE[style, exchange]
    seed0, sweep0 = (-5, 2), 37
    ju, ja, jdu = _jax_chain(base, seed0, sweep0, shard)
    u, ln_u, du, xu = SC.chunk_draws(SC.chain_key(base, seed0, sweep0), S,
                                     NVOL, R, "cpu", shard)
    assert xu.shape == (0, R)
    assert u.shape == ln_u.shape == (S, NVOL, R) and du.shape == (S,)
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  ju.view(np.int32))
    np.testing.assert_array_equal(du.numpy().view(np.int32),
                                  jdu.view(np.int32))
    # the same uniform under ln_u, and XLA's log within an ulp of torch's
    np.testing.assert_array_equal(
        ln_u.numpy().view(np.int32),
        torch.log(torch.as_tensor(ja)).numpy().view(np.int32))
    assert _ulps(ln_u.numpy(), jnp.log(jnp.asarray(ja))) <= 1
    # the volume scale on these draws: pow(x, 1/3) against jnp.cbrt
    x = (1.0 + 0.05 * (2.0 * u - 1.0)).numpy()
    s = torch.pow(torch.as_tensor(x), 1.0 / 3.0).numpy()
    assert _ulps(s, jnp.cbrt(jnp.asarray(x))) <= 1


def test_base_keys_follow_the_jax_engines():
    assert SC.CHAIN_BASE == {("pair", False): 0, ("pair", True): 1,
                             ("eam", False): 2, ("eam", True): 2}


@pytest.mark.parametrize("with_chunk", [False, True])
def test_exchange_draws_are_the_jax_event_keys(with_chunk):
    """Alone (the sharded runner's) and in the chunk's one pass (the
    exchange runner's)."""
    xkey, sweep0, mod, nrec = 13, 40, 3, 5
    if with_chunk:
        keys = SC.exchange_keys(jrandom.key(xkey), sweep0, mod, nrec)
        got = SC.chunk_draws(SC.chain_key(1, (3, 4), sweep0), nrec * mod,
                             NVOL, NPRESS * NTEMP, "cpu", None, keys)[3]
    else:
        got = SC.exchange_draws(jrandom.key(xkey), sweep0, mod, nrec,
                                NPRESS * NTEMP, "cpu")
    jk = jax.random.key(xkey)
    for e in range(nrec):
        ekey = jax.random.fold_in(jax.random.fold_in(jk, e),
                                  sweep0 + (e + 1) * mod)
        axis = (1, 1, 0, 0)[e % 4]
        shape = (NPRESS, NTEMP) if axis == 1 else (NTEMP, NPRESS)
        want = np.asarray(jax.random.uniform(ekey, shape, jnp.float32,
                                             1e-38, 1.0)).reshape(-1)
        np.testing.assert_array_equal(got[e].numpy().view(np.int32),
                                      want.view(np.int32))
