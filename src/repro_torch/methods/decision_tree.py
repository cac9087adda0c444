"""Decision trees (C4.5 style, paper Table 1): level-wise growth.

The port's counterpart of the reference ``methods/decision_tree.py``.
Growing one tree level is ONE aggregate pass: the transition routes each
row to its current leaf, bins each feature, and counts rows per (leaf,
feature, bin, class); merge = sum; the driver picks, per leaf, the
(feature, threshold) of the best C4.5 gain ratio.  One scan per level,
not per node.

The tree is stored as fixed-capacity tensors (a complete binary tree of
2^(depth + 1) - 1 slots), so prediction is ``depth`` gather steps.

Exactness: the counts are f32 sums of 1.0s (``index_add`` into the
flattened 4-D state), exact below 2^24 per cell in any order.  Bins use
the quantiles module's JAX-faithful :func:`bin_index`.  ``torch.argmax``
returns the first of tied maxima, as ``jnp.argmax`` does, so ties in
gain ratio pick the same split.  Class labels are taken in ``[0, C)``:
the reference drops an out-of-range label's count and wraps a negative
one, and so does the port.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.plan import ScanAgg, execute
from ..core.table import Table
from .quantiles import bin_index


@dataclasses.dataclass
class TreeModel:
    feature: torch.Tensor     # (nodes,) int32, -1 = leaf
    threshold: torch.Tensor   # (nodes,) float32
    leaf_class: torch.Tensor  # (nodes,) int32 majority class
    depth: int


class SplitStatsAggregate(Aggregate):
    """Histogram sufficient statistics for one tree level.

    State: (n_leaves, n_features, n_bins, n_classes) f32 counts.  Bins
    are equi-width over per-feature ``[lo, hi]``.
    """

    merge_ops = MERGE_SUM

    def __init__(self, model: TreeModel, level: int, lo: torch.Tensor,
                 hi: torch.Tensor, n_bins: int, n_classes: int):
        self.model = model
        self.level = level
        self.lo, self.hi = lo, hi
        self.n_bins, self.n_classes = n_bins, n_classes

    def init(self, block):
        x = block["x"]
        return torch.zeros((2 ** self.level, x.shape[-1], self.n_bins,
                            self.n_classes), dtype=torch.float32,
                           device=x.device)

    def transition(self, state, block, mask):
        x, y = block["x"], block["y"].to(torch.int64)
        n, d = x.shape
        c, nb = self.n_classes, self.n_bins
        leaf = _route(self.model, x, self.level).to(torch.int64)   # (n,)
        t = (x - self.lo) / torch.clamp(self.hi - self.lo, min=1e-30)
        bins = bin_index(t * nb, nb)                                # (n, d)
        y = torch.where(y < 0, y + c, y)       # JAX wraps negative indices
        keep = (y >= 0) & (y < c)              # and drops out-of-range ones
        upd = (mask & keep).to(torch.float32)
        feat = torch.arange(d, device=x.device)
        flat = ((leaf[:, None] * d + feat[None, :]) * nb + bins) * c \
            + y.clamp(0, c - 1)[:, None]
        return state.reshape(-1).index_add(
            0, flat.reshape(-1),
            upd[:, None].expand(n, d).reshape(-1)).reshape(state.shape)


def _route(model: TreeModel, x: torch.Tensor, level: int) -> torch.Tensor:
    """Position of each row among the 2^level frontier nodes."""
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(level):
        f = model.feature[node].to(torch.int64)
        thr = model.threshold[node]
        go_right = torch.gather(x, 1, f.clamp(min=0)[:, None])[:, 0] > thr
        node = 2 * node + 1 + go_right.to(torch.int64)
    return node - (2 ** level - 1)


def _entropy(counts: torch.Tensor) -> torch.Tensor:
    """counts (..., C) -> entropy (...)."""
    n = torch.sum(counts, -1, keepdim=True)
    p = counts / torch.clamp(n, min=1e-30)
    return -torch.sum(torch.where(
        p > 0, p * torch.log2(torch.clamp(p, min=1e-30)),
        torch.zeros_like(p)), dim=-1)


def _best_splits(stats: torch.Tensor, lo, hi, min_rows: float):
    """Per-leaf best (feature, threshold) by C4.5 gain ratio.

    stats: (L, D, B, C).  Candidate thresholds are bin edges; left/right
    class counts come from cumulative sums along the bin axis.
    """
    L, D, B, C = stats.shape
    total = torch.sum(stats, dim=2)                         # (L, D, C)
    node_counts = total[:, 0, :]                            # (L, C)
    n_node = torch.sum(node_counts, -1)                     # (L,)
    parent_h = _entropy(node_counts)                        # (L,)

    cum = torch.cumsum(stats, dim=2)                        # (L, D, B, C)
    left = cum[:, :, :-1, :]                                # split after b
    right = total[:, :, None, :] - left
    nl = torch.sum(left, -1)
    nr = torch.sum(right, -1)
    n = torch.clamp(nl + nr, min=1e-30)
    child_h = (nl * _entropy(left) + nr * _entropy(right)) / n
    gain = parent_h[:, None, None] - child_h                # (L, D, B-1)
    # C4.5 gain ratio: penalize by split information
    pl = nl / n
    split_info = -(pl * torch.log2(torch.clamp(pl, min=1e-30))
                   + (1 - pl) * torch.log2(torch.clamp(1 - pl, min=1e-30)))
    ratio = gain / torch.clamp(split_info, min=1e-3)
    valid = (nl >= min_rows) & (nr >= min_rows)
    ratio = torch.where(valid, ratio, torch.full_like(ratio, -float("inf")))

    flat = ratio.reshape(L, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    feat = torch.div(best, B - 1, rounding_mode="floor")
    b = best % (B - 1)
    width = (hi - lo) / torch.tensor(float(B), device=hi.device)
    thr = lo[feat] + (b + 1).to(torch.float32) * width[feat]
    majority = torch.argmax(node_counts, -1).to(torch.int32)
    no_split = (best_gain <= 0.0) | (n_node < 2 * min_rows)
    return feat.to(torch.int32), thr, majority, no_split


def decision_tree_fit(table: Table, *, num_classes: int, max_depth: int = 4,
                      n_bins: int = 32, min_rows: float = 8.0,
                      block_size: int | None = None) -> TreeModel:
    """Grow a tree level by level, one ``dtree:split_stats`` scan per
    level and one more for the last level's leaf classes."""
    x = table["x"]
    d, dev = x.shape[-1], x.device
    nodes = 2 ** (max_depth + 1) - 1
    feature = torch.full((nodes,), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((nodes,), dtype=torch.float32, device=dev)
    leaf_class = torch.zeros((nodes,), dtype=torch.int32, device=dev)
    lo = torch.amin(x, dim=0)
    hi = torch.amax(x, dim=0) + 1e-6

    def run(model, level):
        return execute(ScanAgg(
            SplitStatsAggregate(model, level, lo, hi, n_bins, num_classes),
            table, block_size=block_size, label="dtree:split_stats"))

    for level in range(max_depth):
        model = TreeModel(feature, threshold, leaf_class, max_depth)
        feat, thr, majority, no_split = _best_splits(run(model, level), lo,
                                                     hi, min_rows)
        idx = slice(2 ** level - 1, 2 ** (level + 1) - 1)
        feature, threshold, leaf_class = (
            feature.clone(), threshold.clone(), leaf_class.clone())
        feature[idx] = torch.where(no_split, torch.full_like(feat, -1), feat)
        threshold[idx] = thr
        leaf_class[idx] = majority
    # the last level: leaf classes from one more stats pass
    model = TreeModel(feature, threshold, leaf_class, max_depth)
    counts = torch.sum(run(model, max_depth), dim=(1, 2)) / d
    leaf_class = leaf_class.clone()
    leaf_class[2 ** max_depth - 1:] = torch.argmax(counts, -1).to(
        torch.int32)
    return TreeModel(feature, threshold, leaf_class, max_depth)


def decision_tree_predict(model: TreeModel, x: torch.Tensor) -> torch.Tensor:
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    cls = model.leaf_class[node]
    for _ in range(model.depth):
        f = model.feature[node].to(torch.int64)
        is_leaf = f < 0
        thr = model.threshold[node]
        go_right = torch.gather(x, 1, f.clamp(min=0)[:, None])[:, 0] > thr
        nxt = 2 * node + 1 + go_right.to(torch.int64)
        node = torch.where(is_leaf, node, nxt)
        cls = model.leaf_class[node]
    return cls
