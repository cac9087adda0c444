"""Templated queries (MADlib §3.1.3): the port's counterpart of the
reference ``core/templates.py``.

MADlib generates SQL from templates by reading the catalog.  Here a
templated aggregate reads the schema of the block it is given and builds
its computation for whatever columns are there.  :class:`ProfileAggregate`
(MADlib's ``profile``) is the flagship: per numeric column a univariate
summary whose state mixes merge combinators (count and moments sum, min
takes the min, max the max), built from the schema in ``init``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels import registry as _kernels
from .aggregates import MERGE_MAX, MERGE_MIN, MERGE_SUM, Aggregate
from .table import Columns, Table


def is_numeric(dtype: torch.dtype) -> bool:
    """Integers and floats; bool is not a number, as in ``jnp.number``."""
    return dtype != torch.bool and not dtype.is_complex


class ProfileAggregate(Aggregate):
    """Schema-generic univariate statistics over every numeric column.

    State per column: {count, sum, sumsq, min, max} in f32; ``final``
    adds mean and std.  The merge-combinator tree is built from the input
    schema in ``init``, which also runs on ``meta`` tensors (the planner
    probes it that way before any data moves).
    """

    def __init__(self):
        self.merge_ops = None  # built in init()

    def cache_key(self):
        return ("profile",)

    def init(self, block: Columns):
        state, ops = {}, {}
        for name, col in block.items():
            if not is_numeric(col.dtype):
                continue
            shape = tuple(col.shape[1:])

            def full(v, shape=shape, dev=col.device):
                return torch.full(shape, v, dtype=torch.float32, device=dev)

            state[name] = {"count": full(0.0, ()), "sum": full(0.0),
                           "sumsq": full(0.0), "min": full(float("inf")),
                           "max": full(float("-inf"))}
            ops[name] = {"count": MERGE_SUM, "sum": MERGE_SUM,
                         "sumsq": MERGE_SUM, "min": MERGE_MIN,
                         "max": MERGE_MAX}
        self.merge_ops = ops
        return state

    def transition(self, state, block: Columns, mask):
        """One ``column_stats`` call a column (the kernel on the card, its
        plain version on the CPU), which folds the block into the
        column's state."""
        out = {}
        for name, st in state.items():
            col = block[name].to(torch.float32)
            out[name] = dict(zip(
                ("count", "sum", "sumsq", "min", "max"),
                _kernels.dispatch("column_stats", col, mask, st)))
        return out

    def final(self, state):
        out = {}
        for name, st in state.items():
            n = torch.clamp(st["count"], min=1.0)
            mean = st["sum"] / n
            var = torch.clamp(st["sumsq"] / n - mean ** 2, min=0.0)
            out[name] = dict(st, mean=mean, std=torch.sqrt(var))
        return out


def map_columns(table: Table,
                fn: Callable[[str, torch.Tensor], torch.Tensor | None]
                ) -> Table:
    """Apply ``fn(name, column)`` to every column; drop columns mapped to
    None.  A templated SELECT-expression generator."""
    cols = {}
    for name, col in table.columns.items():
        new = fn(name, col)
        if new is not None:
            cols[name] = new
    return Table(cols, table.mesh, table.row_axes)


def one_hot_encode(table: Table, column: str, num_classes: int) -> Table:
    """Templated categorical expansion: replaces an int column with an
    ``(n, num_classes)`` f32 one-hot column.  Ids outside
    ``[0, num_classes)`` give a row of zeros, as ``jax.nn.one_hot`` does."""
    col = table[column].to(torch.int32)
    classes = torch.arange(num_classes, dtype=torch.int32, device=col.device)
    return table.with_column(column,
                             (col[:, None] == classes).to(torch.float32))
