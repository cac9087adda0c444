"""Plain PyTorch version of the column_stats kernel: the arithmetic of
``ProfileAggregate.transition`` for one column (the reference package has
no kernel here; its profile is plain jnp)."""

import torch


def column_stats_ref(col: torch.Tensor, mask: torch.Tensor, state=None):
    """(N, ...) f32 column and (N,) bool mask -> (count, sum, sumsq, min,
    max) of the valid rows, f32: count a scalar, the others of
    ``col.shape[1:]``.  ``sum`` adds ``x * m`` and ``sumsq``
    ``(x * x) * m``, so a NaN in a masked row still reaches them; ``min``
    and ``max`` skip masked rows and propagate NaN.  Given ``state`` (a
    mapping with those five keys, a running profile state), the block is
    folded into it: ``state + block`` for the count and the sums,
    ``torch.minimum`` and ``torch.maximum`` for the others."""
    mr = mask.reshape((-1,) + (1,) * (col.dim() - 1))
    m = mr.to(torch.float32)
    inf = float("inf")
    count = mask.to(torch.float32).sum()
    s = (col * m).sum(dim=0)
    sq = (col * col * m).sum(dim=0)
    lo = torch.where(mr, col, inf).amin(dim=0)
    hi = torch.where(mr, col, -inf).amax(dim=0)
    if state is None:
        return count, s, sq, lo, hi
    return (state["count"] + count, state["sum"] + s, state["sumsq"] + sq,
            torch.minimum(state["min"], lo), torch.maximum(state["max"], hi))
