"""Frozen copy of the port's Threefry-2x32 generator (the bits of
``jax.random`` under ``jax_threefry_partitionable``), for the benchmark's
inputs and the plain references.

A key is an int64 tensor ``(..., 2)`` of two uint32 words; uint32 sums are
taken in int64 and masked to 32 bits.  Every function is batched over the
key's leading axes.  The benchmark's tests hold these bits to the port's
``prng`` at fixed seeds; the copy stays as it is when the port changes.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of Threefry-2x32 on int64 tensors of uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    """``PRNGKey(seed)``: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` broadcast over the key's batch axes and ``data``."""
    if isinstance(data, int):
        d = torch.full((), data & MASK32, dtype=torch.int64, device=k.device)
    else:
        d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(k: torch.Tensor, num=2) -> torch.Tensor:
    """``(K..., 2)`` -> ``(K..., *num, 2)``."""
    shape = _shape(num)
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device).reshape(shape)
    idx = (...,) + (None,) * len(shape)
    y0, y1 = threefry2x32(k[..., 0][idx], k[..., 1][idx], counts >> 32, counts & MASK32)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits_at(k: torch.Tensor, counts: torch.Tensor, ndim: int) -> torch.Tensor:
    """32 random bits at the flat stream positions ``counts`` (its last
    ``ndim`` axes are sample axes)."""
    idx = (...,) + (None,) * ndim
    y0, y1 = threefry2x32(k[..., 0][idx], k[..., 1][idx], counts >> 32, counts & MASK32)
    return y0 ^ y1


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as a float in [0, 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_at(k: torch.Tensor, counts: torch.Tensor, ndim: int = 1) -> torch.Tensor:
    return unit_float(bits_at(k, counts, ndim))


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """Uniforms in [0, 1): ``(K..., 2)`` -> ``(K..., *shape)``."""
    shape = _shape(shape)
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device).reshape(shape)
    return unit_float(bits_at(k, counts, len(shape)))


def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """jax's two-draw ``randint`` for int32 bounds (as int64)."""
    shape = _shape(shape)
    ks = split(k, 2)
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device).reshape(shape)
    higher = bits_at(ks[..., 0, :], counts, len(shape))
    lower = bits_at(ks[..., 1, :], counts, len(shape))
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = ((_mul32(higher % span, mult) + lower % span) & MASK32) % span
    out = (minval + off) & MASK32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """``sqrt(2) * erfinv(u)``, u uniform in [nextafter(-1, 0), 1)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    f = uniform(k, shape)
    lo_t = torch.full((), lo, dtype=torch.float32, device=k.device)
    hi_t = torch.full((), 1.0, dtype=torch.float32, device=k.device)
    u = torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t)
    return torch.full((), math.sqrt(2.0), dtype=torch.float32, device=k.device) * torch.erfinv(u)
