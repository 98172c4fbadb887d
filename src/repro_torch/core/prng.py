"""Counter-based PRNG: jax's default ``threefry2x32``, bit for bit.

The sampler's seed contract (paper §4.1) is that site ``i`` draws its
inverse-CDF uniforms from ``fold_in(key, i)``, so every schedule sharing a
base key draws the same randoms.  Holding the port to the JAX package's
samples therefore needs jax's generator itself, not ``torch.Generator``:
this module reproduces ``jax.random.key`` / ``fold_in`` / ``split`` /
``uniform`` / ``normal`` / ``randint`` under jax's defaults (impl
``threefry2x32``, ``jax_threefry_partitionable=True``).

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words, the
same words ``jax.random.key_data`` shows.  Keys live on the CPU (they are
two words); ``uniform`` builds its counters on the requested device and
hashes them with torch integer ops, so the CPU and the card give the same
bits.  uint32 arithmetic is carried in int64 and masked to 32 bits.

Keys stay real tensors under a ``FakeTensorMode`` (the dry run's,
``launch/dryrun.py``): :func:`key`, :func:`fold_in`, :func:`split` and
:func:`split_at` derive them with the fake mode unset, so a key's words can
be read on the host at every site; only the draws of :func:`uniform` and
its kin become fake.  Without a fake mode the unset is a no-op.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on counter words
    ``(x1, x2)``.  Works on Python ints and on int64 tensors alike."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(key: torch.Tensor) -> tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a key has shape (2,), got {tuple(key.shape)}")
    k1, k2 = (int(w) for w in key.tolist())
    return k1, k2


def _as_key(k1, k2) -> torch.Tensor:
    with unset_fake_temporarily():
        return torch.tensor([int(k1), int(k2)], dtype=torch.int64)


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)``: the 64-bit seed split into (hi, lo) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _as_key(seed >> 32, seed & _MASK)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, data) with the key."""
    k1, k2 = _words(key)
    return _as_key(*threefry2x32(k1, k2, 0, int(data) & _MASK))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key i hashes counter (0, i).
    Returns ``(num, 2)`` keys."""
    k1, k2 = _words(key)
    with unset_fake_temporarily():
        lo = torch.arange(num, dtype=torch.int64)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        return torch.stack([b1, b2], dim=1)


def split_at(key: torch.Tensor, num: int, index: int) -> torch.Tensor:
    """``split(key, num)[index]``, indexed with any fake mode unset."""
    keys = split(key, num)
    with unset_fake_temporarily():
        return keys[int(index)]


def _bits(key: torch.Tensor, size: int, device, offset: int = 0) -> tuple:
    """The two hash words for flat counters offset..offset+size-1 (64-bit
    iota split into hi/lo words, as jax's partitionable random bits do)."""
    k1, k2 = _words(key)
    counts = torch.arange(offset, offset + size, dtype=torch.int64,
                          device=device)
    return threefry2x32(k1, k2, counts >> 32, counts & _MASK)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            dtype: torch.dtype = torch.float64, device=None,
            offset: int = 0, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: random
    mantissa bits under the exponent of 1.0, minus 1, on ``[0, 1)``; then
    ``max(minval, u·(maxval − minval) + minval)`` in ``dtype``.

    ``offset`` starts the flat counters there: the draw is then the slice
    ``[offset, offset + prod(shape))`` of a larger draw with the same key
    (in row-major order), so a big array can be drawn a piece at a time."""
    shape = tuple(int(s) for s in shape)
    b1, b2 = _bits(key, math.prod(shape), device, offset)
    if dtype == torch.float32:
        mant = (b1 ^ b2) >> 9                               # 23 mantissa bits
        one = 0x3F800000
        floats = (mant | one).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        mant = (b1 << 20) | (b2 >> 12)                      # (hi:lo) >> 12
        one = 0x3FF0000000000000
        floats = (mant | one).view(torch.float64)
    else:
        raise ValueError(f"uniform covers float32 and float64, got {dtype}")
    floats = (floats - 1.0).reshape(shape)
    if (minval, maxval) == (0.0, 1.0):
        return floats
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: two
    draws of 32 random bits (keys ``split(key)``), ``hi`` and ``lo``; with
    span = maxval − minval (1 when maxval ≤ minval), the offset
    ((hi mod span)·m + lo mod span) mod span, m = (2¹⁶ mod span)² mod span,
    every product and sum wrapping at 2³² as jax's uint32 arithmetic (so m
    is 0 for a span above 2¹⁶, where (2¹⁶)² wraps);
    ``maxval`` above the int32 range is clipped to it and the span then
    counts the top value too.  int32 on ``device``."""
    shape = tuple(int(s) for s in shape)
    lo_i32, hi_i32 = -2 ** 31, 2 ** 31 - 1
    wide = maxval > hi_i32
    minval = min(max(int(minval), lo_i32), hi_i32)
    maxval = min(max(int(maxval), lo_i32), hi_i32)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    if wide and maxval > minval:
        span = (span + 1) & _MASK
    k1, k2 = split(key)
    n = math.prod(shape)
    higher, lower = (b1 ^ b2 for b1, b2 in (_bits(k, n, device)
                                            for k in (k1, k2)))
    if span == 0:                 # the whole uint32 range: no remainder
        offset = lower
    else:
        mult = (((2 ** 16 % span) ** 2) & _MASK) % span
        offset = (((higher % span) * mult) & _MASK) + lower % span
        offset = (offset & _MASK) % span
    out = (minval + offset) & _MASK
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).reshape(shape)


def normal(key: torch.Tensor, shape: Sequence[int] = (),
           dtype: torch.dtype = torch.float64, device=None,
           offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for a real dtype: √2 times
    erfinv of a uniform on ``(nextafter(−1, 0), 1)``.  The uniforms are
    jax's bit for bit; torch's erfinv rounds otherwise than XLA's, so the
    normals agree to a few ulp.  ``offset`` as in :func:`uniform`."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).item()
    u = uniform(key, shape, dtype, device, offset, minval=lo, maxval=1.0)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2), dtype=dtype,
                                          device=u.device)
