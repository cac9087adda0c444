"""The Flajolet-Martin sketch over integer items, with the frozen hash
family of ``sketch_hash``, as ``profile`` makes it of integer columns.

FM: bit
``r`` of bitmap ``j`` is set when some item's hash ``j`` has its lowest
set bit at ``r``; the estimate is ``2 ** mean(R) / 0.77351``, ``R`` being
each bitmap's lowest unset bit.
"""

from __future__ import annotations

import torch

from .sketch_hash import as_u32, hash_row, lowest_set_bit

FM_PHI = 0.77351


def fm_bitmaps(items: torch.Tensor, num_hashes: int = 8,
               bits: int = 32) -> torch.Tensor:
    """(num_hashes, bits) bool bitmaps of ``items``."""
    x = as_u32(items)
    out = torch.zeros((num_hashes, bits), dtype=torch.bool,
                      device=items.device)
    for j in range(num_hashes):
        r = lowest_set_bit(hash_row(x, j), bits)
        out[j, torch.unique(r)] = True
    return out


def fm_estimate(maps: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """The FM estimate of (..., H, bits) bitmaps, in float32 as MADlib's
    sketch states it: a mean of small integers (exact), a power of two
    and a division, each rounded once, so equal bitmaps give equal
    bits."""
    unset = ~maps
    first = torch.argmax(unset.to(torch.int8), dim=-1)
    r = torch.where(unset.any(dim=-1), first, torch.full_like(first, bits))
    return 2.0 ** r.to(torch.float32).mean(dim=-1) / FM_PHI
