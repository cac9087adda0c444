"""A frozen copy of the sketches' hash family, so that the reference
hashes as the statements under test must and depends on no code of
theirs.

Item ``x``, read as uint32, gets the hash ``fmix32(x * p_d + p_d)`` for
row ``d``, with the eight odd multipliers of ``PRIMES``.  The arithmetic
runs in int64, masked to 32 bits after every multiply and add.
"""

from __future__ import annotations

import torch

PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
          0xD3A2646C, 0xFD7046C5, 0xB55A4F09)
U32 = 0xFFFFFFFF


def as_u32(items: torch.Tensor) -> torch.Tensor:
    """Integer items as uint32 bit patterns held in int64 (an int32 -1
    becomes 2^32 - 1)."""
    return items.to(torch.int32).to(torch.int64) & U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def hash_row(x: torch.Tensor, d: int) -> torch.Tensor:
    """Hash ``d`` of uint32 items ``x`` (int64)."""
    p = PRIMES[d]
    return fmix32((x * p + p) & U32)


def lowest_set_bit(h: torch.Tensor, bits: int) -> torch.Tensor:
    """Position of the lowest set bit of each uint32 hash, or ``bits - 1``
    where no bit below ``bits`` is set."""
    low = h & -h
    _, exp = torch.frexp(low.double())
    pos = exp.to(torch.int64) - 1
    return torch.where((h == 0) | (pos >= bits),
                       torch.full_like(pos, bits - 1), pos)
