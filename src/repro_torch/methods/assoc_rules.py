"""Association rules (Apriori, paper Table 1): a level-wise driver over
support-counting UDAs.

The port's counterpart of the reference ``methods/assoc_rules.py``.
Transactions are rows of an item-incidence matrix ``(n, n_items)``.
Counting the support of a batch of candidate itemsets is one aggregate
pass: per row, a candidate is contained when the minimum over its item
columns is 1; merge = sum.  Candidate generation (join and prune) is
small driver work on the host with ``itertools``, as in the reference.

Itemsets are fixed-width index rows padded with -1 (an always-true
column).  The transition takes the running minimum one itemset position
at a time, so a block holds ``(rows, candidates)`` and never the
reference's ``(rows, candidates, width)`` gather; the minimum is exact,
so the counts are the same.  Counts are f32 sums of 0/1, exact below
2^24 rows per pass.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.plan import ScanAgg, execute
from ..core.table import Table


class SupportAggregate(Aggregate):
    """Counts how many rows contain each candidate itemset."""

    merge_ops = MERGE_SUM

    def __init__(self, candidates: torch.Tensor):
        self.candidates = candidates   # (C, width) int32, -1 padded

    def init(self, block):
        return torch.zeros((self.candidates.shape[0],), dtype=torch.float32,
                           device=block["items"].device)

    def transition(self, state, block, mask):
        items = block["items"].to(torch.float32)         # (B, I)
        n_items = items.shape[1]
        padded = torch.cat([items, items.new_ones((items.shape[0], 1))], 1)
        cand = self.candidates.to(device=items.device, dtype=torch.int64)
        idx = torch.where(cand < 0, n_items, cand)       # -1 -> always true
        contained = padded[:, idx[:, 0]]                 # (B, C)
        for w in range(1, idx.shape[1]):
            contained = torch.minimum(contained, padded[:, idx[:, w]])
        return state + torch.sum(
            contained * mask.to(torch.float32)[:, None], dim=0)


@dataclasses.dataclass
class AssocRules:
    itemsets: list       # list of tuples
    supports: dict       # itemset -> support fraction
    rules: list          # (antecedent, consequent, support, confidence)


def _count(table, candidates, block_size):
    agg = SupportAggregate(torch.as_tensor(candidates, dtype=torch.int32,
                                           device=table.device))
    return execute(ScanAgg(agg, table, block_size=block_size,
                           label="assoc:support"))


def apriori(table: Table, *, min_support: float = 0.1,
            min_confidence: float = 0.5, max_len: int = 3,
            block_size: int | None = None) -> AssocRules:
    n = table.n_rows
    n_items = table["items"].shape[1]
    supports: dict[tuple, float] = {}

    # level 1
    c1 = np.full((n_items, max_len), -1, np.int32)
    c1[:, 0] = np.arange(n_items)
    counts = _count(table, c1, block_size).cpu().numpy()
    for i, s in zip(range(n_items), counts):
        if s / n >= min_support:
            supports[(i,)] = float(s / n)
    level = [(i,) for i in range(n_items) if counts[i] / n >= min_support]

    for width in range(2, max_len + 1):
        # join step: unions of (width-1)-itemsets that make width items
        cands = sorted({tuple(sorted(set(a) | set(b)))
                        for a in level for b in level
                        if len(set(a) | set(b)) == width})
        # prune step: every (width-1)-subset must be frequent
        cands = [c for c in cands
                 if all(tuple(s) in supports
                        for s in itertools.combinations(c, width - 1))]
        if not cands:
            break
        arr = np.full((len(cands), max_len), -1, np.int32)
        for r, c in enumerate(cands):
            arr[r, :width] = c
        counts = _count(table, arr, block_size).cpu().numpy()
        level = []
        for c, s in zip(cands, counts):
            if s / n >= min_support:
                supports[c] = float(s / n)
                level.append(c)
        if not level:
            break

    rules = []
    for itemset, supp in supports.items():
        if len(itemset) < 2:
            continue
        for r in range(1, len(itemset)):
            for ante in itertools.combinations(itemset, r):
                conf = supp / supports[tuple(sorted(ante))]
                if conf >= min_confidence:
                    cons = tuple(sorted(set(itemset) - set(ante)))
                    rules.append((ante, cons, supp, conf))
    return AssocRules(sorted(supports), supports, rules)
