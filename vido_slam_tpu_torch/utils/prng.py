"""Threefry-2x32 keys, ``split``, ``fold_in`` and float32 ``uniform``,
bit-equal to ``jax.random`` with ``jax_threefry_partitionable=True`` (the
default of current JAX), and float32 ``normal`` through XLA's ``erf_inv``
polynomial.

A key is an int64 tensor of shape (..., 2) holding two uint32 words. Each
draw hashes a 64-bit counter (the flat element index, split into a high and
a low word) with the key: ``split(key, n)[i] = threefry(key, (0, i))`` and
``uniform(key, shape)`` takes the two output words XOR-ed. The uint32
arithmetic runs in int64 with ``& 0xFFFFFFFF``, since PyTorch's uint32 has
few operators. The state is explicit: every draw takes its key, nothing is
global.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block function on int64 tensors that hold
    uint32 values; key words broadcast against the counter words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key (0, seed) of a seed in [0, 2**31), as ``jax.random.PRNGKey``
    makes it with 64-bit types disabled (JAX's default)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError("seed must be in [0, 2**31)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _hash(key: torch.Tensor, size: int):
    """Threefry of counters 0..size-1 under each key of (..., 2)."""
    if size >= 2 ** 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    hi = torch.zeros_like(lo)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(2,) key -> (num, 2) keys, as ``jax.random.split``."""
    b1, b2 = _hash(key, num)
    return torch.stack([b1, b2], dim=-1)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 uniform on [0, 1) of ``shape``, as ``jax.random.uniform``.
    A key of shape (..., 2) draws independently per leading index and
    returns (..., *shape)."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = _hash(key, math.prod(shape))
    bits = b1 ^ b2
    # 23 random mantissa bits under the exponent of 1.0, minus 1.0
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0).reshape(key.shape[:-1] + shape)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """(2,) key -> the (2,) key of ``jax.random.fold_in(key, data)``: the
    threefry of the counter words (0, data) under the key."""
    d = torch.tensor(int(data) & _MASK, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([b1, b2])


# XLA's float32 ErfInv (M. Giles' single-precision approximation): the
# coefficients for w = -log1p(-x^2) below 5, and for w >= 5
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's polynomial and its
    operation order (``lax.erf_inv``); +-1 map to +-inf. XLA on the CPU
    contracts each Horner step into a fused multiply-add, emulated here in
    float64 (the product of two float32 values is exact there)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LO[0], _ERFINV_HI[0]).to(x.dtype)
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        c = torch.where(lt, lo, hi).to(x.dtype).double()
        p = (c + p.double() * w).to(x.dtype)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard normal of ``shape``, as ``jax.random.normal``:
    sqrt(2) erf_inv(u) of u uniform on (-1, 1), drawn as ``uniform``'s
    bits scaled by 2 from the float after -1. Equal to JAX's but for about one
    draw in a hundred, an ulp apart (``log1p``'s rounding)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape).to(key.device)
    u = torch.clamp(u * 2.0 + lo, min=lo)
    return erf_inv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32)
