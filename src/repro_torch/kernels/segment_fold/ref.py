"""Plain PyTorch versions of the segment-fold kernels (counterpart of
the reference package's ``kernels/segment_fold/ref.py``).

Each computes what the generic grouped path computes: the aggregate's
own transition arithmetic (mask-multiply forms) per group-aligned block,
merged into the block's group slot.  Sentinel blocks (``gid ==
num_groups``, from ``pad_blocks_to``) fall outside every slot and are
dropped, as the reference's out-of-range scatter drops them.  Each
returns the fold-from-zero state stack; the caller merges it with the
per-group inits.

The sketch versions are integer-exact, so they need not replay the
block order: every valid row's update goes into its block's group slot
in one ``index_add_`` (Count-Min, a sum) or ``scatter_reduce_`` with
``amax`` (Flajolet-Martin, an OR over {0, 1}) per hash.
"""

from __future__ import annotations

import torch

from ..sketch_hash import _check_rows, _lowest_set_bit, as_u32, hash_row


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


def _row_slots(bgids, valid, bs: int, num_groups: int):
    """Each row's group slot (clamped into range) and its update: the
    validity as int32, 0 for rows of sentinel blocks."""
    row_g = bgids.to(torch.int64).repeat_interleave(bs)
    keep = valid & (row_g >= 0) & (row_g < num_groups)
    return row_g.clamp(0, max(num_groups - 1, 0)), keep.to(torch.int32)


def segment_countmin_ref(items, valid, bgids, *, depth: int, width: int,
                         num_groups: int):
    """Whole-fold Count-Min stack: (N2,) items -> (G, depth, width) i32."""
    _check_rows(depth, "segment_countmin: depth")
    nb = bgids.shape[0]
    bs = _blocked(items, nb).shape[1]
    out = torch.zeros((num_groups * depth * width,), dtype=torch.int32,
                      device=items.device)
    if num_groups:
        gi, upd = _row_slots(bgids, valid, bs, num_groups)
        x = as_u32(items)
        for d in range(depth):
            flat = (gi * depth + d) * width + hash_row(x, d) % width
            out.index_add_(0, flat, upd)
    return out.view(num_groups, depth, width)


def segment_fm_ref(items, valid, bgids, *, num_hashes: int, bits: int,
                   num_groups: int):
    """Whole-fold Flajolet-Martin stack: (N2,) items -> (G, H, bits) i32
    {0,1} bitmaps, OR-merged per group."""
    _check_rows(num_hashes, "segment_fm: num_hashes")
    nb = bgids.shape[0]
    bs = _blocked(items, nb).shape[1]
    out = torch.zeros((num_groups * num_hashes * bits,), dtype=torch.int32,
                      device=items.device)
    if num_groups:
        gi, upd = _row_slots(bgids, valid, bs, num_groups)
        x = as_u32(items, saturate_floats=True)
        for j in range(num_hashes):
            r = _lowest_set_bit(hash_row(x, j), bits)
            out.scatter_reduce_(0, (gi * num_hashes + j) * bits + r, upd,
                                reduce="amax")
    return out.view(num_groups, num_hashes, bits)
