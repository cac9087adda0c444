"""MADlib's ``profile``: per numeric column its count, sum, sum of
squares, minimum, maximum, mean and standard deviation (population), and
an FM distinct-count estimate for each 1-D integer column.

The reference sums in float64; minimum and maximum are exact in any
order.  The control rounds every value to TF32 and sums in float32.
"""

from __future__ import annotations

from typing import Iterable

import torch

from .sketches import fm_bitmaps, fm_estimate
from .tf32 import round_tf32


def stats(blocks: Iterable[dict], *, tf32: bool = False,
          fm_columns=(), num_hashes: int = 8, bits: int = 32) -> dict:
    """``{column: {count, sum, sumsq, min, max, mean, std,
    [approx_distinct]}}`` over the rows of ``blocks`` (and ``integer``:
    whether the column holds integers)."""
    dt = torch.float32 if tf32 else torch.float64
    acc: dict = {}
    maps: dict = {}
    for blk in blocks:
        for name, col in blk.items():
            v = col.to(torch.float32)
            if tf32:
                v = round_tf32(v)
            v = v.to(dt)
            a = acc.get(name)
            if a is None:
                shape = tuple(v.shape[1:])
                a = acc[name] = {
                    "integer": not col.dtype.is_floating_point,
                    "count": 0.0,
                    "sum": torch.zeros(shape, dtype=dt, device=v.device),
                    "sumsq": torch.zeros(shape, dtype=dt, device=v.device),
                    "min": torch.full(shape, float("inf"), dtype=dt,
                                      device=v.device),
                    "max": torch.full(shape, float("-inf"), dtype=dt,
                                      device=v.device)}
            a["count"] += v.shape[0]
            a["sum"] += v.sum(0)
            a["sumsq"] += (v * v).sum(0)
            a["min"] = torch.minimum(a["min"], v.amin(0))
            a["max"] = torch.maximum(a["max"], v.amax(0))
            if name in fm_columns:
                m = fm_bitmaps(col, num_hashes, bits)
                maps[name] = m if name not in maps else maps[name] | m
    out = {}
    for name, a in acc.items():
        n = a["count"]
        mean = a["sum"] / n
        var = torch.clamp(a["sumsq"] / n - mean ** 2, min=0.0)
        out[name] = dict(a, mean=mean, std=torch.sqrt(var))
        if name in maps:
            out[name]["approx_distinct"] = fm_estimate(maps[name], bits)
    return out
