"""Carry tables and fold states between the reference package and the
port, as numpy arrays.

A fold state made by one package can be merged with a fold of further
rows made by the other: both hold OLS states as the same dict of
``xtx``, ``xty``, ``y_sum``, ``y_sq`` and ``n``, solo or stacked with a
leading group axis ``(G, ...)``.  Sketch states carry across the same
way, as int32 arrays: a Count-Min ``(depth, width)`` counter matrix or
an FM ``(num_hashes, bits)`` bitmap, or their ``(G, ...)`` stacks,
through the same :func:`state_from_numpy` and :func:`state_to_numpy`;
they merge with the aggregate's own combinator (sum, max) and stay
exact.  A fit's parameters need nothing more: the reference's k-means
centroids or IRLS coefficients, as numpy arrays, are the port's
``init_centroids`` and ``warm_start`` as they are, and a ``FitResult``
state goes back through :func:`state_to_numpy`.  Nothing here imports
the reference package: the caller converts its arrays with
``numpy.asarray``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.table import Table
from .device import resolve_device
from .tree import tree_map


def table_from_numpy(columns: Mapping[str, Any], device=None) -> Table:
    """A port :class:`Table` from a mapping of column name -> array (a
    reference table's columns passed through ``numpy.asarray``)."""
    return Table.from_columns(
        {k: np.asarray(v) for k, v in columns.items()}, device=device)


def state_from_numpy(state, device=None):
    """A fold state tree of numpy arrays -> the same tree of tensors on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), state)


def state_to_numpy(state):
    """A fold state tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)
