"""The part of ``jax.random`` that the attacks draw from, in torch — keys,
``fold_in``, 32-bit random bits and f32 normals, on the device of the
tensors they poison.

JAX's default PRNG is threefry-2x32 with 20 rounds (Salmon et al. 2011)
over pairs of uint32 words. This module reproduces:

- :func:`PRNGKey` — ``(0, seed mod 2³²)``, as JAX builds it without x64;
- :func:`fold_in` — ``threefry2x32(key, (0, data))``;
- :func:`random_bits` — the *partitionable* layout that JAX uses when
  ``jax_threefry_partitionable`` is on (its default): element ``i`` of
  the flat output is ``b1 ^ b2`` of ``threefry2x32(key, (i >> 32,
  i & 0xFFFFFFFF))``;
- :func:`normal` — ``√2 · erfinv(u)``, ``u`` uniform on
  ``[nextafter(−1, 0), 1)`` from the top 23 bits of each word, with
  ``erfinv`` the single-precision polynomial of Giles (2010) that XLA
  lowers ``lax.erf_inv`` to (``torch.erfinv`` rounds differently).

uint32 words live in int64 tensors; every add and rotate is masked back
to 32 bits. Keys and bits are bit-equal to ``jax.random``'s; normals
agree to the last bits of ``log1p`` and the polynomial's roundings.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from tpfl_torch import DeviceLike, resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# Giles' erfinv for w = -log1p(-x²) < 5 and >= 5 (XLA's ErfInv32).
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
           -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
           -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


Words = Union[torch.Tensor, int]


def _rotl(x: Words, r: int) -> Words:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Sequence[int], x0: Words, x1: Words) -> tuple[Words, Words]:
    """The threefry-2x32 hash (20 rounds) of the word pairs ``(x0, x1)``
    — int64 tensors holding uint32 values, or Python ints — under
    ``key``, a pair of Python ints."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words without x64: ``(0, seed
    mod 2³²)`` (negative seeds wrap; the high word is always 0)."""
    return 0, int(seed) & _M32


def fold_in(key: Sequence[int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: threefry of the word pair
    ``(0, data)`` under ``key``."""
    return threefry2x32(key, 0, int(data) & _M32)


def random_bits(key: Sequence[int], shape: Sequence[int],
                device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` in the partitionable
    layout, as int64 values in ``[0, 2³²)`` on ``device`` (None: the
    card)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    b0, b1 = threefry2x32(key, idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: Sequence[int], shape: Sequence[int], minval: float, maxval: float,
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform`` in f32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to ``[minval, maxval)``."""
    bits = random_bits(key, shape, device)
    device = bits.device
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``ErfInv``: Giles' polynomial in ``w = −log1p(−x²)``,
    ±inf at ±1, as ``lax.erf_inv`` gives."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.tensor(_W_LT_5[0], dtype=x.dtype, device=x.device),
                    torch.tensor(_W_GE_5[0], dtype=x.dtype, device=x.device))
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        c = torch.where(lt, torch.tensor(a, dtype=x.dtype, device=x.device),
                        torch.tensor(b, dtype=x.dtype, device=x.device))
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: Sequence[int], shape: Sequence[int], device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    u = uniform(key, shape, _LO, 1.0, device)
    return np.float32(np.sqrt(2)).item() * erfinv(u)


__all__ = ["PRNGKey", "erfinv", "fold_in", "normal", "random_bits", "threefry2x32", "uniform"]
