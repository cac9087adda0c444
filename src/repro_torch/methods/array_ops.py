"""Array operations support module (paper Table 1).

The port's counterpart of the reference ``methods/array_ops.py``: thin
wrappers over torch, the MADlib ``array_*`` UDF surface, so method code
and users write intent-revealing calls.  ``axis=None`` reduces every
axis, as in the reference.
"""

from __future__ import annotations

import torch


def array_add(a, b):
    return torch.add(a, b)


def array_sub(a, b):
    return torch.subtract(a, b)


def array_mult(a, b):
    return torch.multiply(a, b)


def array_div(a, b):
    return torch.divide(a, b)


def array_dot(a, b):
    """``vdot``: both flattened, the first conjugated."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def array_scalar_mult(a, s):
    return a * s


def array_sum(a, axis=None):
    return torch.sum(a) if axis is None else torch.sum(a, dim=axis)


def array_mean(a, axis=None):
    return torch.mean(a) if axis is None else torch.mean(a, dim=axis)


def array_max(a, axis=None):
    return torch.amax(a) if axis is None else torch.amax(a, dim=axis)


def array_min(a, axis=None):
    return torch.amin(a) if axis is None else torch.amin(a, dim=axis)


def array_sqrt(a):
    return torch.sqrt(a)


def array_pow(a, p):
    return torch.pow(a, p)


def norm1(a):
    return torch.sum(torch.abs(a))


def norm2(a):
    return torch.sqrt(torch.sum(a * a))


def array_filter(a, predicate, fill=0.0):
    """Masked filter with static shape (SQL WHERE over array elements)."""
    return torch.where(predicate(a), a, fill)


def closest_column(matrix: torch.Tensor, vec: torch.Tensor):
    """MADlib's closest_column(a, b) used by k-means (§4.3): index of the
    matrix ROW closest to ``vec`` (MADlib stores centroids column-wise;
    row-wise here) plus the distance."""
    d2 = torch.sum((matrix - vec[None, :]) ** 2, dim=-1)
    idx = torch.argmin(d2)
    return idx, torch.sqrt(d2[idx])
