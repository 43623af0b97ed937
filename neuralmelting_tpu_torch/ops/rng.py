"""Counter-based threefry2x32 for the sweep kernel's draws (plain torch).

Counterpart of the in-kernel generator of
``neuralmelting_tpu/ops/pallas/cellmc.py`` (``threefry2x32``,
``_bits_to_u01``, and the sweep kernel's ``sym16``), bit for bit. The
CUDA kernel computes the same stream from ``csrc/threefry.cuh``.

The JAX code works on int32 with wrapping adds. torch's ``>>`` on int32 is
an arithmetic shift, so here every word is an int64 tensor holding the
uint32 value (0 <= v < 2^32), and every add is masked back to 32 bits.
Inputs may be int32 (two's complement) or int64; outputs are int64 words
in [0, 2^32) — ``to_int32`` gives the JAX int32 view.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_TF_C = 0x1BD11BDA


def _u32(x) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.as_tensor(x)
    return x.to(torch.int64) & _MASK


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Random123; JAX's default generator)."""
    k0, k1, x0, x1 = _u32(k0), _u32(k1), _u32(x0), _u32(x1)
    ks = [k0, k1, k0 ^ k1 ^ _TF_C]
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _TF_ROT[4 * (i % 2):4 * (i % 2) + 4]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def threefry2x32_int(k0: int, k1: int, x0: int, x1: int):
    """``threefry2x32`` on Python ints (uint32 values): a host key chain's
    step without a tensor operation."""
    ks = (k0, k1, k0 ^ k1 ^ _TF_C)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i, rots in enumerate(_TF_ROUNDS):
        for r, rr in rots:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> rr)) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


# the five rounds' (rotation, 32 - rotation) pairs
_TF_ROUNDS = tuple(tuple((r, 32 - r) for r in _TF_ROT[4 * (i % 2):
                                                      4 * (i % 2) + 4])
                   for i in range(5))


def bits_to_u01(b):
    """32-bit word -> f32 uniform in (0, 1] (never 0: log-safe)."""
    return ((_u32(b) & 0x7FFFFF) + 1).to(torch.float32) * (2.0 ** -23)


def sym16(b, sh: int):
    """16-bit field at bit ``sh`` -> symmetric f32 in (-1, 1): values
    +-(2m+1)/65536, a symmetric discrete displacement proposal."""
    v = (_u32(b) >> sh) & 0xFFFF
    return (v.to(torch.float32) - 32767.5) * (1.0 / 32768.0)


def to_int32(w) -> torch.Tensor:
    """uint32 words held in int64 -> the same bits as int32."""
    w = _u32(w)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
