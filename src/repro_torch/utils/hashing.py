"""Deterministic 32-bit hashing (splitmix-style finalizer), bit-equal to
``repro.utils.hashing``.

PyTorch has no arithmetic on ``uint32`` (``add`` and ``remainder`` refuse it),
so every hash is computed on int64 holding the unsigned value and masked to
32 bits.  Results are returned as int32 tensors holding the same bit pattern
as the JAX package's uint32 keys; ``as_u32`` recovers the unsigned value.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned 32-bit value of an integer tensor's low 32 bits, as int64."""
    return x.to(torch.int64) & MASK32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """An int64 tensor of values in [0, 2**32) as int32 with the same bits."""
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for x in [0, 2**32), without int64 overflow: the
    multiplier is split into 16-bit halves."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _splitmix(x: torch.Tensor) -> torch.Tensor:
    x = (x + _GOLDEN) & MASK32
    x = _mul32(x ^ (x >> 16), _M1)
    x = _mul32(x ^ (x >> 13), _M2)
    return x ^ (x >> 16)


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on the low 32 bits of ``x``; int32 bit pattern."""
    return to_i32(_splitmix(as_u32(x)))


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Hash a 32-bit array elementwise (``splitmix32``); int32 bit pattern."""
    return splitmix32(x)


def hash2_u32_unsigned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``hash2_u32`` as an int64 tensor of unsigned values in [0, 2**32)."""
    a = as_u32(a)
    b = as_u32(b)
    mix = (b + _GOLDEN + ((a << 6) & MASK32) + (a >> 2)) & MASK32
    return _splitmix(_splitmix(a) ^ mix)


def hash2_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hash a pair of 32-bit arrays to one (order-sensitive); int32 bit pattern."""
    return to_i32(hash2_u32_unsigned(a, b))


def _splitmix_int(x: int) -> int:
    x = (x + _GOLDEN) & MASK32
    x = ((x ^ (x >> 16)) * _M1) & MASK32
    x = ((x ^ (x >> 13)) * _M2) & MASK32
    return x ^ (x >> 16)


def hash2_u32_int(a: int, b: int) -> int:
    """``hash2_u32`` of two Python ints (their low 32 bits), as the unsigned
    value in [0, 2**32): for host-side keys, one at a time, without
    launching a tensor op per key."""
    a &= MASK32
    b &= MASK32
    mix = (b + _GOLDEN + ((a << 6) & MASK32) + (a >> 2)) & MASK32
    return _splitmix_int(_splitmix_int(a) ^ mix)
