"""Quantiles (paper Table 1) via a mergeable histogram sketch UDA.

The port's counterpart of the reference ``methods/quantiles.py``.  A
fixed-range equi-width histogram is the classic in-database quantile
sketch: the transition bins values, merge = sum of bins, and the
quantiles interpolate from the cumulative histogram.  A preliminary
profile pass fixes the range: two passes in all.

The bin index is the reference's bit for bit.  Its solo transition
reads ``trunc((v - lo) / max(hi - lo, 1e-30) * bins)`` with Python-float
``lo`` and ``hi``; JAX rounds them to f32 (weak types), and its compiled
program turns the division by that constant into a multiply by the f32
reciprocal and folds ``* bins`` into it: ``(v - lo) * c`` with
``c = f32(f32(1 / d) * bins)``.  The port multiplies by the same ``c``
(:func:`range_scale`).  The grouped transition divides by a per-row
range, a true f32 division in both.  JAX's float-to-int conversion
saturates and sends NaN to 0; :func:`bin_index` does the same before
the cast.  A histogram that differed by one row in one bin would move a
quantile by a whole bin.  The scatter-add of 1.0s into the f32
histogram is exact below 2^24 rows per bin, in any order.
"""

from __future__ import annotations

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.plan import GroupedScanAgg, ScanAgg, execute
from ..core.table import Table
from ..core.templates import ProfileAggregate


def bin_index(f: torch.Tensor, bins: int) -> torch.Tensor:
    """``clip(int32(f), 0, bins - 1)`` of a scaled value ``f`` as JAX
    computes it: NaN to 0, saturation, truncation toward zero."""
    f = torch.nan_to_num(f, nan=0.0)
    return torch.clamp(f, 0.0, float(bins - 1)).to(torch.int64)


def range_scale(lo: float, hi: float, bins: int) -> float:
    """The f32 factor that takes ``v - lo`` to bins in the reference's
    compiled solo transition: ``f32(f32(1 / f32(d)) * bins)``."""
    d = torch.tensor(max(hi - lo, 1e-30), dtype=torch.float32)
    return float(torch.reciprocal(d) * torch.tensor(float(bins)))


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


class HistogramAggregate(Aggregate):
    merge_ops = MERGE_SUM

    def __init__(self, lo: float, hi: float, bins: int = 4096,
                 value_col: str = "v"):
        self.lo, self.hi, self.bins = float(lo), float(hi), bins
        self.value_col = value_col

    def cache_key(self):
        return ("histogram", self.lo, self.hi, self.bins, self.value_col)

    def init(self, block):
        return torch.zeros((self.bins,), dtype=torch.float32,
                           device=block[self.value_col].device)

    def transition(self, state, block, mask):
        v = block[self.value_col].to(torch.float32)
        dev = v.device
        f = (v - _f32(self.lo, dev)) \
            * _f32(range_scale(self.lo, self.hi, self.bins), dev)
        return state.index_add(0, bin_index(f, self.bins),
                               mask.to(torch.float32))


class GroupedHistogramAggregate(Aggregate):
    """Per-group-range histogram: ``lo``/``hi`` are ``(G,)`` tensors and
    each row bins against ITS group's range, looked up through a group-id
    data column; the state stays one ``(bins,)`` histogram, and the
    grouped engine keeps the groups apart."""

    merge_ops = MERGE_SUM

    def __init__(self, lo: torch.Tensor, hi: torch.Tensor, bins: int = 4096,
                 value_col: str = "v", gid_col: str = "__g__"):
        self.lo, self.hi, self.bins = lo, hi, bins
        self.value_col = value_col
        self.gid_col = gid_col

    def init(self, block):
        return torch.zeros((self.bins,), dtype=torch.float32,
                           device=block[self.value_col].device)

    def transition(self, state, block, mask):
        g = torch.clamp(block[self.gid_col].to(torch.int64), 0,
                        self.lo.shape[0] - 1)
        v = block[self.value_col].to(torch.float32)
        lo, hi = self.lo[g], self.hi[g]
        t = (v - lo) / torch.clamp(hi - lo, min=1e-30)
        return state.index_add(0, bin_index(t * self.bins, self.bins),
                               mask.to(torch.float32))


def _interp_quantiles(hist, lo, width, qs, bins):
    """Quantiles ``(..., len(qs))`` from histograms ``(..., bins)`` whose
    first bins start at ``lo`` and span ``width`` (f32 tensors of the
    leading shape)."""
    cdf = torch.cumsum(hist, -1) / torch.clamp(
        torch.sum(hist, -1, keepdim=True), min=1.0)
    q = torch.as_tensor(qs, dtype=torch.float32, device=hist.device)
    q = q.expand(cdf.shape[:-1] + q.shape).contiguous()
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), q), 0, bins - 1)
    return lo[..., None] + (idx.to(torch.float32) + 0.5) * width[..., None]


def quantiles(table: Table, qs, *, value_col: str = "v", bins: int = 4096,
              block_size: int | None = None) -> torch.Tensor:
    """Approximate quantiles with error <= range / bins.  Two planned
    statements with a data dependency (the profile pass fixes the
    histogram's range), so they execute as two plans."""
    prof = execute(ScanAgg(ProfileAggregate(), table,
                           columns=(value_col,), block_size=block_size,
                           label="quantiles:range"))[value_col]
    lo, hi = float(prof["min"]), float(prof["max"])
    hist = execute(ScanAgg(HistogramAggregate(lo, hi, bins, value_col),
                           table, block_size=block_size,
                           label="quantiles:hist"))
    # the reference's Python-float lo and width, each rounded to f32
    return _interp_quantiles(hist, _f32(lo, hist.device),
                             _f32((hi - lo) / bins, hist.device), qs, bins)


def quantiles_grouped(table: Table, key_col: str, qs, *,
                      num_groups: int | None = None, value_col: str = "v",
                      bins: int = 4096, block_size: int | None = None,
                      mesh=None) -> torch.Tensor:
    """Per-group approximate quantiles (``... GROUP BY g``) in two grouped
    passes: a grouped profile fixes each group's range, then one grouped
    histogram pass bins every row against its own group's range.
    Returns ``(num_groups, len(qs))``; groups with no rows yield
    non-finite values (their range is empty).

    The two statements share ONE partitioning sort through the
    ``Table.group_by`` memo; the group id rides along as a data column
    for the histogram's range lookup.  ``mesh`` (the table's when None)
    runs both passes on the sharded grouped engine."""
    gcol = table[key_col]
    t = Table({value_col: table[value_col], "__g__": gcol, key_col: gcol},
              table.mesh, table.row_axes)
    prof = execute(GroupedScanAgg(
        ProfileAggregate(), t, key_col, num_groups, columns=(value_col,),
        block_size=block_size, mesh=mesh,
        label="quantiles_grouped:range"))[value_col]
    lo, hi = prof["min"], prof["max"]
    hist = execute(GroupedScanAgg(
        GroupedHistogramAggregate(lo, hi, bins, value_col), t, key_col,
        num_groups, block_size=block_size, mesh=mesh,
        label="quantiles_grouped:hist"))
    width = (hi - lo) / _f32(float(bins), hist.device)
    return _interp_quantiles(hist, lo, width, qs, bins)
