"""Plain PyTorch version of the countmin kernel (counterpart of the
reference package's ``kernels/countmin/ref.py``).  It uses the method
layer's hash, so a sketch it builds is one that ``countmin_query``
reads."""

from __future__ import annotations

import torch

from ..sketch_hash import _hash_rows


def countmin_block_ref(items, mask, depth: int, width: int) -> torch.Tensor:
    """(n,) items and (n,) mask -> (depth, width) int32 counts: row ``d``
    adds each row's mask (as int32) into bucket ``hash_d(item)``."""
    idx = _hash_rows(items, depth, width)              # (depth, n)
    upd = mask.to(torch.int32)
    out = torch.zeros((depth, width), dtype=torch.int32, device=items.device)
    for d in range(depth):
        out[d].index_add_(0, idx[d], upd)
    return out
