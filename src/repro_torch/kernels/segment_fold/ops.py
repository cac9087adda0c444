"""PyTorch wrapper of the CUDA segment_linregr kernel
(``csrc/segment_linregr.cu``).

It takes the group-aligned layout as ``segment_fold`` holds it:
``(N2, K)`` permuted and padded x, ``(N2,)`` y and validity, ``(nb,)``
int32 block gids.  On CUDA tensors it checks them and launches the
kernel, or raises; on CPU tensors it runs the plain version in
``ref.py``.  ``segment_linregr_launches`` counts the kernel's launches.
Count-Min and Flajolet-Martin segment kernels are not ported yet.
"""

from __future__ import annotations

import torch

from ...device import runs_on_card
from .. import _build
from .ref import segment_linregr_ref

# launches of the CUDA kernel pair (per-block Gram + per-group reduce)
segment_linregr_launches = 0

_GRID_YZ_MAX = 65535
_TILE = 64


def _layout(n2: int, nb: int) -> int:
    """Block size of the group-aligned layout; loud on a torn layout."""
    if nb <= 0 or n2 % nb:
        raise ValueError(f"segment_fold kernels: {n2} rows do not form "
                         f"{nb} equal group-aligned blocks")
    return n2 // nb


def _check(x, y, valid, bgids) -> None:
    if x.dim() != 2 or y.shape != (x.shape[0],) \
            or valid.shape != (x.shape[0],) or bgids.dim() != 1:
        raise ValueError(
            "segment_linregr: want x (N2, K), y (N2,), valid (N2,), "
            f"bgids (nb,); got {tuple(x.shape)}, {tuple(y.shape)}, "
            f"{tuple(valid.shape)}, {tuple(bgids.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"segment_linregr: want float32 x and y, got "
                        f"{x.dtype} and {y.dtype}")
    if valid.dtype != torch.bool or bgids.dtype != torch.int32:
        raise TypeError(f"segment_linregr: want bool valid and int32 "
                        f"bgids, got {valid.dtype} and {bgids.dtype}")
    if len({t.device for t in (x, y, valid, bgids)}) != 1:
        raise ValueError("segment_linregr: inputs on different devices")
    if not all(t.is_contiguous() for t in (x, y, valid, bgids)):
        raise ValueError("segment_linregr: inputs must be contiguous")


def segment_linregr(x, y, valid, bgids, *, num_groups: int):
    """(N2,K) x, (N2,) y, (N2,) valid, (nb,) bgids -> stacked (G, ...)
    linregr state dict (fold-from-zero)."""
    global segment_linregr_launches
    _check(x, y, valid, bgids)
    n2, k = x.shape
    nb = bgids.shape[0]
    bs = _layout(n2, nb)
    if not runs_on_card(x, "segment_linregr"):
        return segment_linregr_ref(x, y, valid, bgids,
                                   num_groups=num_groups)
    w = k + 2
    if -(-w // _TILE) > _GRID_YZ_MAX or -(-w * w // 256) > _GRID_YZ_MAX:
        raise ValueError(f"segment_linregr: K={k} is too wide for the "
                         "kernel's grid")
    if max(nb, bs, num_groups) >= 2 ** 31:
        raise ValueError("segment_linregr: too many blocks, rows per block "
                         "or groups for the kernel's int arguments")
    dev = x.device
    partials = torch.empty((nb, w, w), dtype=torch.float32, device=dev)
    # pass 2 writes every element of every group, empty ones as zeros
    shapes = {"xtx": (num_groups, k, k), "xty": (num_groups, k),
              "y_sum": (num_groups,), "y_sq": (num_groups,),
              "n": (num_groups,)}
    out = {name: torch.empty(shape, dtype=torch.float32, device=dev)
           for name, shape in shapes.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().madlib_segment_linregr(
        x.data_ptr(), y.data_ptr(), valid.data_ptr(), bgids.data_ptr(),
        partials.data_ptr(), out["xtx"].data_ptr(), out["xty"].data_ptr(),
        out["y_sum"].data_ptr(), out["y_sq"].data_ptr(),
        out["n"].data_ptr(), nb, bs, k, num_groups, stream)
    _build.check("segment_linregr", err)
    segment_linregr_launches += 1
    return out
