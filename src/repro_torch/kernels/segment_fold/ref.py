"""Plain PyTorch version of the segment_linregr kernel (counterpart of
the reference package's ``kernels/segment_fold/ref.py``).

It replays the generic grouped path block by block: the aggregate's own
transition arithmetic (mask-multiply forms) per group-aligned block,
added into the block's group slot.  Sentinel blocks (``gid ==
num_groups``, from ``pad_blocks_to``) fall outside every slot and are
dropped, as the reference's out-of-range scatter drops them.  Returns
the fold-from-zero state stack; the caller merges it with the per-group
inits.
"""

from __future__ import annotations

import torch


def _blocked(arr: torch.Tensor, nb: int) -> torch.Tensor:
    n2 = arr.shape[0]
    if nb <= 0 or n2 % nb:
        raise ValueError(f"segment_fold ref: {n2} rows do not form {nb} "
                         "equal blocks")
    return arr.reshape((nb, n2 // nb) + tuple(arr.shape[1:]))


def segment_linregr_ref(x, y, valid, bgids, *, num_groups: int):
    """(N2,K) x / (N2,) y / (N2,) valid with ``nb`` group-aligned blocks
    -> the linregr state dict stacked (G, ...)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    nb = bgids.shape[0]
    k = x.shape[1]
    f = x.dtype
    dev = x.device
    xb, yb, vb = _blocked(x, nb), _blocked(y, nb), _blocked(valid, nb)
    acc = {
        "xtx": torch.zeros((num_groups, k, k), dtype=f, device=dev),
        "xty": torch.zeros((num_groups, k), dtype=f, device=dev),
        "y_sum": torch.zeros((num_groups,), dtype=f, device=dev),
        "y_sq": torch.zeros((num_groups,), dtype=f, device=dev),
        "n": torch.zeros((num_groups,), dtype=torch.float32, device=dev),
    }
    for b, g in enumerate(bgids.tolist()):
        if not 0 <= g < num_groups:
            continue
        m = vb[b]
        xm = xb[b] * m[:, None].to(f)
        ym = yb[b] * m.to(f)
        acc["xtx"][g] += xm.T @ xm
        acc["xty"][g] += xm.T @ ym
        acc["y_sum"][g] += ym.sum()
        acc["y_sq"][g] += (ym * ym).sum()
        acc["n"][g] += m.to(torch.float32).sum()
    return acc
