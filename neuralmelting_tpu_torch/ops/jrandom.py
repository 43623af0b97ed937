"""The ``jax.random`` stream, in torch: the host draws of the serial engine.

Counterpart of the parts of ``jax.random`` (jax 0.9.0, threefry2x32 keys,
``jax_threefry_partitionable=True``) that the JAX package's serial engine
draws from, bit for bit, on CPU and CUDA tensors alike:

* ``key(seed)``: the words [0, seed mod 2^32] (jax in 32-bit mode);
* ``split(key, n)``: word pair i = threefry(key, (0, i));
* ``fold_in(key, d)``: threefry(key, (0, d));
* ``random_bits(key, shape)``: w0 ^ w1 of threefry(key, (hi, lo)) over the
  flat 64-bit counter of each element;
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, then ``f * (max - min) + min`` and ``max(min, .)``, in f32, with the
  multiply-add rounded once: XLA's CPU backend, which made the JAX
  package's golden files, contracts it into an FMA (``fma32``);
* ``randint``: JAX's two-draw modulus algorithm on 32-bit words;
* ``normal``: sqrt(2) erfinv(uniform(nextafter(-1, 0), 1)), with XLA's
  f32 erfinv polynomial (``erfinv``).

A key is a tensor of two words (..., 2), each a uint32 value held in
int64 as in ``ops/rng.py``; leading axes batch: ``split`` of (..., 2)
gives (..., n, 2), the draws give (..., *shape). ``key_data`` gives a
JAX key's words in that form.

Where this is not JAX's bits: ``erfinv`` evaluates XLA's polynomial
(its multiply-adds contracted, as in ``uniform``) on
torch's ``log1p``; XLA's log1p is its own approximation, up to 2 ulps
from torch's, so ``normal`` differs from ``jax.random.normal`` by at most
a few f32 ulps on about 1% of draws (tests/test_torch_jrandom.py measures
it). Every other function is bitwise equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from neuralmelting_tpu_torch.ops.rng import threefry2x32

_MASK = 0xFFFFFFFF
_ONE_BITS = 0x3F800000          # 1.0f


def key(seed: int) -> torch.Tensor:
    """The key of an integer seed: words [0, seed mod 2^32]."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def key_data(k) -> torch.Tensor:
    """A key's words (..., 2) as int64 uint32 values, from a port key or
    from JAX's ``jax.random.key_data`` array (uint32)."""
    if not torch.is_tensor(k):
        k = torch.as_tensor(np.asarray(k).astype(np.int64))
    k = k.to(torch.int64) & _MASK
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key has two words, got shape {tuple(k.shape)}")
    return k


def _hash(k, hi, lo):
    """threefry(k, (hi, lo)) with k (..., 2) against counters of shape S:
    two words of shape (..., *S)."""
    shape = tuple(k.shape[:-1]) + (1,) * hi.dim()
    k0 = k[..., 0].reshape(shape)
    k1 = k[..., 1].reshape(shape)
    return threefry2x32(k0, k1, hi, lo)


def _counters(shape, device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def split(k, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    hi, lo = _counters((num,), k.device)
    b0, b1 = _hash(k, hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(k, data) -> torch.Tensor:
    """``jax.random.fold_in``: (..., 2) and a uint32 datum -> (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    b0, b1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def random_bits(k, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): (..., 2) -> (..., *shape) words."""
    shape = tuple(shape)
    hi, lo = _counters(shape, k.device)
    b0, b1 = _hash(k, hi, lo)
    return b0 ^ b1


def floats01(bits) -> torch.Tensor:
    """32-bit words -> f32 in [0, 1): the top 23 bits as a mantissa."""
    return ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) \
        - 1.0


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def fma32(a, b, c) -> torch.Tensor:
    """a b + c for f32 tensors, rounded once to f32 (the f32 product is
    exact in f64), as XLA's CPU backend contracts a multiply-add."""
    return (a.double() * b.double() + c.double()).float()


def scale_uniform(f, minval, maxval) -> torch.Tensor:
    """``uniform``'s last step on floats in [0, 1): max(min, f (max - min)
    + min), with f32 operands and JAX's contracted multiply-add. min and
    max may be tensors on f's device."""
    lo, hi = _f32(minval, f.device), _f32(maxval, f.device)
    return torch.maximum(lo, fma32(f, hi - lo, lo))


def uniform(k, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return scale_uniform(floats01(random_bits(k, shape)), minval, maxval)


def randint(k, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32)."""
    k1, k2 = split(k, 2).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((higher % span) * mult) & _MASK) + lower % span
    off = (off & _MASK) % span
    return (minval + off).to(torch.int32)


# XLA's f32 erfinv (Giles, "Approximating the erfinv function"), as the
# CPU backend lowers chlo.erf_inv: w = -log1p(-x^2), a degree-8 polynomial
# in w - 2.5 (w < 5) or sqrt(w) - 3, times x; erfinv(+-1) = +-inf.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x) -> torch.Tensor:
    """f32 inverse error function with XLA's polynomial."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0], x.device),
                    _f32(_ERFINV_GE5[0], x.device))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, w, torch.where(lt, _f32(a, x.device), _f32(b, x.device)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return _f32(np.float32(np.sqrt(2)), u.device) * erfinv(u)
