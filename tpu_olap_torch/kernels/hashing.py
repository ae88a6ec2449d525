"""32-bit integer mixing for sketch hashing (HLL / theta).

The JAX package's `kernels/hashing.py` computes in uint32 and relies on
its wraparound. torch's uint32 dtype lacks most arithmetic, so here every
value is a uint32 held in int64 and masked to 32 bits after each step,
and each 32×32-bit multiply is split in two 16-bit halves so that no
int64 product overflows (signed overflow is undefined on the card, even
where it happens to wrap on the CPU). Bit-exact against the JAX
functions. The mix is the standard Murmur3 finalizer.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int tensor -> its low 32 bits as a non-negative int64."""
    return x.to(torch.int64) & _MASK


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), c a uint32 constant, with
    every partial product below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def to_int32(h: torch.Tensor) -> torch.Tensor:
    """uint32 value in int64 -> the int32 with the same bits (explicit:
    an out-of-range narrowing cast is not defined)."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor as int32 (numpy's and JAX's
    astype(int32) on a wider integer)."""
    return to_int32(_u32(x))


def hash32_int(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 over an int32 tensor -> int32 (well-mixed)."""
    h = _u32(x)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return to_int32(h)


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-dependent combine (boost::hash_combine flavored)."""
    ua, ub = _u32(a), _u32(b)
    ua = ua ^ ((ub + 0x9E3779B9 + ((ua << 6) & _MASK) + (ua >> 2)) & _MASK)
    return hash32_int(ua)


def to_unit_float(h: torch.Tensor) -> torch.Tensor:
    """int32 hash -> float64 in [0, 1) (bits read as uint32); exact."""
    return _u32(h).to(torch.float64) / float(1 << 32)
