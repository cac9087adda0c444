"""The sketches' hash family in plain PyTorch: the counterpart of
``csrc/sketch_hash.cuh`` and of the hashing at the top of the reference
package's ``methods/sketches.py``.

Item ``x`` (read as uint32) gets the hash ``fmix32(x * p_d + p_d)`` for
each row ``d`` of the sketch, with the eight odd multipliers of
``_PRIMES``.  PyTorch on the CPU has no uint32 shift, remainder or
subtraction, so the arithmetic runs in int64 and is masked with
``& 0xFFFFFFFF`` after every multiply and add.  A product of two values
below 2^32 may overflow int64; torch wraps it, and the mask keeps the
low 32 bits, which is all uint32 arithmetic keeps.

Everything here is shared by the method layer (``methods/sketches.py``
re-exports it) and by the kernels' plain versions, so a sketch built by
a kernel and a query read by the method layer hash alike.
"""

from __future__ import annotations

import torch

_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
           0xD3A2646C, 0xFD7046C5, 0xB55A4F09)
_U32 = 0xFFFFFFFF


def _check_rows(n: int, what: str) -> None:
    if not 1 <= n <= len(_PRIMES):
        raise ValueError(f"{what} must be in [1, {len(_PRIMES)}] (one hash "
                         f"multiplier each), got {n}")


def as_u32(items: torch.Tensor, *, saturate_floats: bool = False
           ) -> torch.Tensor:
    """Items as uint32 bit patterns held in int64.  Integers are cast to
    int32 first, which wraps as the reference's ``astype(int32)`` does
    (an int64 2^40 + 5 becomes 5, -1 becomes 2^32 - 1).  Floats truncate
    toward zero into int32, or, with ``saturate_floats``, clamp into
    [0, 2^32 - 1] as the reference's direct ``astype(uint32)`` does."""
    if items.dtype.is_floating_point and saturate_floats:
        return items.double().trunc().clamp(0, _U32).to(torch.int64)
    return items.to(torch.int32).to(torch.int64) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def hash_row(x: torch.Tensor, d: int) -> torch.Tensor:
    """Hash ``d`` of uint32 items ``x`` (int64): ``fmix32(x p + p)``."""
    p = _PRIMES[d]
    return _fmix32((x * p + p) & _U32)


def _hash_rows(items: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """(n,) items -> (depth, n) int64 bucket indices in [0, width)."""
    _check_rows(depth, "depth")
    x = as_u32(items)
    return torch.stack([hash_row(x, d) % width for d in range(depth)])


def _lowest_set_bit(h: torch.Tensor, bits: int) -> torch.Tensor:
    """Position of the lowest set bit of each uint32 hash, or ``bits - 1``
    when no bit in [0, bits) is set (h == 0, or the lowest set bit lies at
    ``bits`` or above).  Positions from 32 up are never set: a shift of a
    uint32 by 32 or more gives 0 in XLA, as it does for these int64
    values below 2^32.  int64 result."""
    low = h & -h                       # the lowest set bit alone
    _, exp = torch.frexp(low.double())  # low = 0.5 * 2^exp, exactly
    pos = exp.to(torch.int64) - 1
    return torch.where((h == 0) | (pos >= bits),
                       torch.full_like(pos, bits - 1), pos)
