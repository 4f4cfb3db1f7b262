"""Threefry-2x32 keys and draws, bit-identical to ``jax.random`` in the
layout of ``jax_threefry_partitionable=False``.

The JAX package draws every random number of the MMFL round with
threefry-2x32, keyed by index (``core.sampling.index_keys``), so the port
reproduces those draws exactly and both packages follow the same
trajectory from the same state.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
function takes a batch of keys along the leading axes (no vmap).  The words
are held in int64 and masked to 32 bits after each add and shift: shifts on
``torch.uint32`` are patchy on CUDA.

Covered: ``PRNGKey``, ``split``, ``fold_in``, ``uniform``, ``randint``
(what the round draws), and ``normal`` (the linear task's init).  ``split``
and ``randint`` follow the non-partitionable layout; ``uniform(fold_in(k,
i))`` is the same under both layouts.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors of
    uint32 words.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _hash(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``threefry_2x32(key, count)`` of JAX: the flat counts are padded to
    even length, split into halves that form the two input words, hashed,
    and the two output words concatenated.  key [..., 2], count [n] ->
    [..., n]."""
    n = count.shape[0]
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    half = count.shape[0] // 2
    k0, k1 = key[..., 0:1], key[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, count[:half], count[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """Key [2] from an int32 seed (``jax.random.PRNGKey`` without x64)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] uint32 words (in int64) of ``jax.random.bits`` layout."""
    return _hash(key, torch.arange(n, dtype=torch.int64, device=key.device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """key [..., 2] -> [..., num, 2]."""
    out = random_bits(key, 2 * int(num))
    return out.reshape(out.shape[:-1] + (int(num), 2))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """key [..., 2] folded with uint32 ``data`` (broadcast against the key's
    batch shape) -> [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """U[minval, maxval) float32 draws of shape ``key.shape[:-1] + shape``."""
    if dtype != torch.float32:
        raise TypeError("uniform draws float32 only")
    shape = _shape(shape)
    bits = random_bits(key, math.prod(shape))
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA fuses the scale and shift into one fused multiply-add; the exact
    # f32 product plus one rounding in f64 reproduces it
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    out = torch.maximum(lo, scaled)
    return out.reshape(key.shape[:-1] + shape)


def randint(key: torch.Tensor, shape: Shape, minval, maxval) -> torch.Tensor:
    """int32 draws in [minval, maxval) of shape ``key.shape[:-1] + shape``
    (``jax.random.randint``'s two-stream modulus).  ``minval``/``maxval``
    broadcast against that shape."""
    shape = _shape(shape)
    n = math.prod(shape)
    k = split(key, 2)
    hi_bits = random_bits(k[..., 0, :], n).reshape(key.shape[:-1] + shape)
    lo_bits = random_bits(k[..., 1, :], n).reshape(key.shape[:-1] + shape)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = (maxval - minval) & MASK
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (((hi_bits % span) * mult) & MASK) + (lo_bits % span)
    off = (off & MASK) % span
    return (minval + off).to(torch.int32)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Standard normal float32 draws (``jax.random.normal``'s inverse-erf
    transform; equal to it up to the erfinv implementation's rounding)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32,
                                          device=key.device)
