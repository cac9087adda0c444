"""Naive Bayes classification (paper Table 1) as a single-pass UDA.

The port's counterpart of the reference ``methods/naive_bayes.py``.
Gaussian NB over continuous features: per-class sufficient statistics
(count, per-feature sum, sum of squares) accumulate in the transition;
merge = sum; final converts them to class priors and per-class feature
means and variances.  Prediction is a pure map (a templated SELECT).

The per-class sums are ``onehot.T @ x`` in f32 (``torch.matmul``, with
TF32 left off), as the reference computes them outside any kernel: on
dyadic features every sum is exact, so the fold state is bitwise the
reference's whatever the order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.plan import GroupedScanAgg, ScanAgg, execute
from ..core.table import Table


@dataclasses.dataclass
class NaiveBayesModel:
    log_prior: torch.Tensor   # (C,)
    mean: torch.Tensor        # (C, d)
    var: torch.Tensor         # (C, d)


def _one_hot(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot rows; labels outside ``[0, C)`` give a row of zeros,
    as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, dtype=torch.int32, device=y.device)
    return (y[:, None] == classes).to(torch.float32)


class NaiveBayesAggregate(Aggregate):
    merge_ops = MERGE_SUM

    def __init__(self, num_classes: int, var_smoothing: float = 1e-6):
        self.num_classes = num_classes
        self.var_smoothing = var_smoothing

    def cache_key(self):
        return ("naive_bayes", self.num_classes, self.var_smoothing)

    def init(self, block):
        x = block["x"]
        d, c = x.shape[-1], self.num_classes

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=x.device)

        return {"count": zeros(c), "sum": zeros(c, d), "sumsq": zeros(c, d)}

    def transition(self, state, block, mask):
        x = block["x"]
        y = block["y"].to(torch.int32)
        onehot = _one_hot(y, self.num_classes) \
            * mask.to(torch.float32)[:, None]
        return {
            "count": state["count"] + torch.sum(onehot, 0),
            "sum": state["sum"] + onehot.T @ x,
            "sumsq": state["sumsq"] + onehot.T @ (x * x),
        }

    def final(self, s):
        """Priors, means and variances; every field may carry a leading
        group axis."""
        n = torch.clamp(s["count"][..., None], min=1.0)
        mean = s["sum"] / n
        var = torch.clamp(s["sumsq"] / n - mean ** 2, min=0.0) \
            + self.var_smoothing
        total = torch.clamp(torch.sum(s["count"], -1, keepdim=True), min=1.0)
        log_prior = torch.log(torch.clamp(s["count"], min=1e-12) / total)
        return NaiveBayesModel(log_prior, mean, var)

    def final_grouped(self, states):
        return self.final(states)


def naive_bayes_fit(table: Table, num_classes: int, *,
                    block_size: int | None = None) -> NaiveBayesModel:
    agg = NaiveBayesAggregate(num_classes)
    return execute(ScanAgg(agg, table, columns=("x", "y"),
                           block_size=block_size, label="naive_bayes"))


def naive_bayes_grouped(table: Table, key_col: str, num_classes: int,
                        num_groups: int | None = None, *,
                        block_size: int | None = None,
                        method: str = "auto") -> NaiveBayesModel:
    """``SELECT g, naive_bayes(...) FROM data GROUP BY g``: one NB model
    per group through the partitioned grouped-scan core; every model
    field carries a leading group axis."""
    return execute(GroupedScanAgg(
        NaiveBayesAggregate(num_classes), table, key_col, num_groups,
        columns=("x", "y"), block_size=block_size, method=method,
        label="naive_bayes_grouped"))


def naive_bayes_predict(model: NaiveBayesModel,
                        x: torch.Tensor) -> torch.Tensor:
    """argmax_c [ log p(c) + Σ_j log N(x_j; μ_cj, σ²_cj) ]"""
    ll = -0.5 * torch.sum(
        torch.log(2.0 * math.pi * model.var)[None]
        + (x[:, None, :] - model.mean[None]) ** 2 / model.var[None],
        dim=-1)
    return torch.argmax(model.log_prior[None] + ll, dim=-1)
