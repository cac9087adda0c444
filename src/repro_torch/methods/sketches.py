"""Count-Min and Flajolet-Martin sketches (paper Table 1, "Descriptive
Statistics") as UDAs.

The port's counterpart of the reference ``methods/sketches.py``.  Both
sketches show why the UDA merge contract matters:

* Count-Min merge = elementwise **sum** of the (depth, width) counters.
* FM merge = elementwise **OR** of bitmaps (= max over {0, 1}), the
  aggregate that exercises the non-sum merge combinator.

Hashing is the multiply-then-fmix32 family of ``kernels/sketch_hash.py``
(int64 arithmetic masked to 32 bits), re-exported here.  States are
integers, so they equal the reference's bit for bit on any data.  The
Count-Min transition can go through the ``countmin`` kernel, and the
grouped folds through ``segment_countmin`` and ``segment_fm``.
"""

from __future__ import annotations

import torch

from ..core.aggregates import MERGE_MAX, MERGE_SUM, Aggregate
from ..core.plan import GroupedScanAgg, ScanAgg, execute
from ..core.table import Table
from ..kernels.countmin.ref import countmin_block_ref
from ..kernels.registry import dispatch, resolve_impl
from ..kernels.sketch_hash import (  # noqa: F401  (the reference's names)
    _PRIMES, _check_rows, _fmix32, _hash_rows, _lowest_set_bit, as_u32,
    hash_row,
)

# Jensen-corrected FM constant phi
_FM_PHI = 0.77351


class CountMinAggregate(Aggregate):
    """epsilon-delta frequency sketch: state (depth, width) int32
    counters.  ``use_kernel`` routes the transition through the
    ``countmin`` kernel and the grouped fold through
    ``segment_countmin``."""

    merge_ops = MERGE_SUM
    segment_kernel = "segment_countmin"
    cost_class = "sketch"                 # planner calibration bucket

    def __init__(self, depth: int = 4, width: int = 1024,
                 use_kernel: bool | str = False, item_col: str = "item"):
        _check_rows(depth, "CountMinAggregate: depth")
        self.depth, self.width = depth, width
        self.kernel_impl = resolve_impl(use_kernel)
        self.item_col = item_col

    def cache_key(self):
        return ("countmin", self.depth, self.width, self.item_col,
                self.kernel_impl)

    def segment_kernel_args(self, columns, valid, block_gids, num_groups):
        return ((columns[self.item_col], valid, block_gids),
                {"depth": self.depth, "width": self.width,
                 "num_groups": num_groups})

    def init(self, block):
        dev = block[self.item_col].device
        return torch.zeros((self.depth, self.width), dtype=torch.int32,
                           device=dev)

    def transition(self, state, block, mask):
        items = block[self.item_col]
        if self.kernel_impl is not None:
            return state + dispatch("countmin", items, mask, self.depth,
                                    self.width, impl=self.kernel_impl)
        return state + countmin_block_ref(items, mask, self.depth,
                                          self.width)


def countmin_query(sketch: torch.Tensor, items) -> torch.Tensor:
    """Point-estimate frequencies: the min over the depth rows."""
    depth, width = sketch.shape
    items = torch.as_tensor(items, device=sketch.device)
    idx = _hash_rows(items, depth, width)                 # (depth, n)
    return torch.gather(sketch, 1, idx).amin(dim=0)


class FMAggregate(Aggregate):
    """Flajolet-Martin distinct-count sketch.

    State: (num_hashes, bits) {0,1} bitmaps; the transition ORs in the
    bit at the lowest set bit of each item hash; merge = OR (max).
    Final: the FM estimate 2^mean(R) / phi, phi = 0.77351, with R the
    lowest unset bit of each bitmap.  ``use_kernel`` routes the grouped
    fold through ``segment_fm`` (the solo transition has no kernel, as
    in the reference).
    """

    merge_ops = MERGE_MAX
    segment_kernel = "segment_fm"
    cost_class = "sketch"                 # planner calibration bucket

    def __init__(self, num_hashes: int = 8, bits: int = 32,
                 item_col: str = "item", use_kernel: bool | str = False):
        _check_rows(num_hashes, "FMAggregate: num_hashes")
        self.num_hashes, self.bits = num_hashes, bits
        self.item_col = item_col
        self.kernel_impl = resolve_impl(use_kernel)

    def cache_key(self):
        return ("fm", self.num_hashes, self.bits, self.item_col,
                self.kernel_impl)

    def segment_kernel_args(self, columns, valid, block_gids, num_groups):
        return ((columns[self.item_col], valid, block_gids),
                {"num_hashes": self.num_hashes, "bits": self.bits,
                 "num_groups": num_groups})

    def init(self, block):
        dev = block[self.item_col].device
        return torch.zeros((self.num_hashes, self.bits), dtype=torch.int32,
                           device=dev)

    def transition(self, state, block, mask):
        x = as_u32(block[self.item_col], saturate_floats=True)
        upd = mask.to(torch.int32)
        out = state.clone()
        for j in range(self.num_hashes):
            r = _lowest_set_bit(hash_row(x, j), self.bits)
            out[j].scatter_reduce_(0, r, upd, reduce="amax")
        return out

    def final(self, state):
        """Estimate from a (H, bits) state, or a (G, H, bits) stack."""
        unset = state == 0
        idx = torch.argmax(unset.to(torch.int8), dim=-1)
        all_set = ~unset.any(dim=-1)
        r = torch.where(all_set, torch.full_like(idx, self.bits), idx)
        return 2.0 ** r.to(torch.float32).mean(dim=-1) / _FM_PHI

    def final_grouped(self, states):
        return self.final(states)


def countmin_sketch(table: Table, *, depth: int = 4, width: int = 1024,
                    item_col: str = "item",
                    block_size: int | None = None) -> torch.Tensor:
    """``SELECT countmin(item) FROM t``: the (depth, width) counters."""
    agg = CountMinAggregate(depth, width, item_col=item_col)
    return execute(ScanAgg(agg, table, block_size=block_size,
                           label="countmin"))


def fm_distinct_count(table: Table, *, num_hashes: int = 8, bits: int = 32,
                      item_col: str = "item",
                      block_size: int | None = None) -> torch.Tensor:
    """``SELECT count(DISTINCT item) FROM t``, approximated."""
    agg = FMAggregate(num_hashes, bits, item_col=item_col)
    return execute(ScanAgg(agg, table, block_size=block_size,
                           label="fm_distinct"))


def countmin_sketch_grouped(table: Table, key_col: str,
                            num_groups: int | None = None, *,
                            depth: int = 4, width: int = 1024,
                            item_col: str = "item",
                            block_size: int | None = None,
                            use_kernel: bool | str = False) -> torch.Tensor:
    """One Count-Min sketch per group: a ``(num_groups, depth, width)``
    counter stack from one partitioned grouped scan, bit-identical to
    sketching each group's rows alone.  Emitted over the original table
    with an ``item_col`` projection, so batched grouped statements share
    one partitioning sort through the ``group_by`` memo."""
    return execute(GroupedScanAgg(
        CountMinAggregate(depth, width, use_kernel=use_kernel,
                          item_col=item_col), table, key_col,
        num_groups, columns=(item_col,), block_size=block_size,
        label="countmin_grouped"))


def fm_distinct_count_grouped(table: Table, key_col: str,
                              num_groups: int | None = None, *,
                              num_hashes: int = 8, bits: int = 32,
                              item_col: str = "item",
                              block_size: int | None = None,
                              use_kernel: bool | str = False
                              ) -> torch.Tensor:
    """Per-group Flajolet-Martin estimates (``SELECT g, count(DISTINCT
    item) GROUP BY g``, approximated): a ``(num_groups,)`` vector from one
    grouped scan."""
    return execute(GroupedScanAgg(
        FMAggregate(num_hashes, bits, item_col=item_col,
                    use_kernel=use_kernel), table, key_col,
        num_groups, columns=(item_col,), block_size=block_size,
        label="fm_grouped"))
