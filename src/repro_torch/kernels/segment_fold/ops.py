"""PyTorch wrappers of the CUDA segment-fold kernels
(``csrc/segment_linregr.cu``, ``csrc/segment_sketch.cu``).

They take the group-aligned layout as ``segment_fold`` holds it:
``(N2, ...)`` permuted and padded columns, ``(N2,)`` validity, ``(nb,)``
int32 block gids.  On CUDA tensors they check them and launch the
kernel, or raise; on CPU tensors they run the plain versions in
``ref.py``; on meta tensors they return outputs of the kernels' shapes
and launch nothing.  ``segment_linregr_launches``,
``segment_countmin_launches`` and ``segment_fm_launches`` count the
kernels' launches.  The ``*_cost`` functions are the work of one call,
which the bound, the dry run and the op counter on the card all read.
"""

from __future__ import annotations

import torch

from ...device import kernel_route
from .. import _build
from ..countmin.ops import CTAS_PER_SM, check_items, item_words, sm_count
from ..sketch_hash import _check_rows
from .ref import segment_countmin_ref, segment_fm_ref, segment_linregr_ref

# launches of the CUDA kernel pair (per-block Gram + per-group reduce)
segment_linregr_launches = 0
# launches of the sketch kernels (one each per call)
segment_countmin_launches = 0
segment_fm_launches = 0

_GRID_YZ_MAX = 65535
# rows per split at most: a block larger than this is cut into row splits
# (xtx's cap on each f32 accumulation chain)
_MAX_SPLIT_ROWS = 8192


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


def block_splits(bs: int) -> tuple[int, int]:
    """(row splits per block, rows per split): the fewest splits of at
    most ``_MAX_SPLIT_ROWS`` rows that cover a block of ``bs`` rows."""
    splits = max(1, -(-bs // _MAX_SPLIT_ROWS))
    return splits, -(-bs // splits)


def _linregr_shapes(g: int, k: int) -> dict:
    return {"xtx": (g, k, k), "xty": (g, k), "y_sum": (g,), "y_sq": (g,),
            "n": (g,)}


def linregr_cost(n2: int, k: int, nb: int, g: int, rows=None
                 ) -> tuple[float, float]:
    """(operations, bytes) of one call over ``rows`` rows (default all
    ``n2``; the bound counts the valid ones, the rows the function needs):
    the upper triangle of each row's (k + 1) x (k + 1) outer product of
    [x | y] and the sums, a multiply and an add each (f32); x, y, the
    validity and the block gids read once, the (G, ...) state written
    once."""
    rows = n2 if rows is None else rows
    return (float(rows) * ((k + 1) * (k + 2) + 2),
            4.0 * n2 * (k + 1) + n2 + 4.0 * nb
            + 4.0 * g * (k * (k + 1) + 3))


def segment_linregr_cost(x, y, valid, bgids, *, num_groups: int):
    """:func:`linregr_cost` of a call: the valid rows where ``valid`` has
    values (on the card a read of their count, as the bound counts them),
    all ``n2`` rows on meta tensors, whose validity has none (an upper
    bound)."""
    rows = None if valid.is_meta else int(valid.sum())
    return linregr_cost(x.shape[0], x.shape[1], bgids.shape[0], num_groups,
                        rows=rows)


def sketch_cost(n2: int, nb: int, cells: int) -> tuple[float, float]:
    """(floating-point operations, bytes) of one call of a segment sketch
    kernel whose per-group state has ``cells`` int32 cells: no floating
    point (the hashes are integer instructions, counted by pipe from the
    SASS for the bound); int32 items, the bool validity and the block
    gids read once, the (G, ...) stack written once."""
    return 0.0, 5.0 * n2 + 4.0 * nb + 4.0 * cells


def segment_countmin_cost(items, valid, bgids, *, depth: int, width: int,
                          num_groups: int):
    return sketch_cost(items.shape[0], bgids.shape[0],
                       num_groups * depth * width)


def segment_fm_cost(items, valid, bgids, *, num_hashes: int, bits: int,
                    num_groups: int):
    return sketch_cost(items.shape[0], bgids.shape[0],
                       num_groups * num_hashes * bits)


def segment_linregr(x, y, valid, bgids, *, num_groups: int):
    """(N2,K) x, (N2,) y, (N2,) valid, (nb,) bgids -> stacked (G, ...)
    linregr state dict (fold-from-zero)."""
    global segment_linregr_launches
    _check(x, y, valid, bgids)
    n2, k = x.shape
    nb = bgids.shape[0]
    bs = _layout(n2, nb)
    route = kernel_route(x, "segment_linregr")
    if route == "cpu":
        return segment_linregr_ref(x, y, valid, bgids,
                                   num_groups=num_groups)
    if route == "meta":
        return {name: x.new_empty(shape)
                for name, shape in _linregr_shapes(num_groups, k).items()}
    w = k + 2
    packed = w * (w + 1) // 2   # the upper triangle of a block's Gram
    if -(-packed // 256) > _GRID_YZ_MAX:
        raise ValueError(f"segment_linregr: K={k} is too wide for the "
                         "kernel's grid")
    splits, rows = block_splits(bs)
    if max(nb * splits, bs, num_groups) >= 2 ** 31:
        raise ValueError("segment_linregr: too many blocks, rows per block "
                         "or groups for the kernel's int arguments")
    dev = x.device
    partials = torch.empty((nb * splits, packed), dtype=torch.float32,
                           device=dev)
    # pass 2 writes every element of every group, empty ones as zeros
    out = {name: torch.empty(shape, dtype=torch.float32, device=dev)
           for name, shape in _linregr_shapes(num_groups, k).items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().madlib_segment_linregr(
        x.data_ptr(), y.data_ptr(), valid.data_ptr(), bgids.data_ptr(),
        partials.data_ptr(), out["xtx"].data_ptr(), out["xty"].data_ptr(),
        out["y_sum"].data_ptr(), out["y_sq"].data_ptr(),
        out["n"].data_ptr(), nb, bs, k, num_groups, splits, rows, stream)
    _build.check("segment_linregr", err)
    segment_linregr_launches += 1
    return out


def _check_sketch(what: str, items, valid, bgids, num_groups: int) -> int:
    """Checks shared by the sketch kernels; returns the block size."""
    check_items(items, valid, what)
    if bgids.dim() != 1 or bgids.dtype != torch.int32:
        raise TypeError(f"{what}: want (nb,) int32 bgids, got "
                        f"{tuple(bgids.shape)} {bgids.dtype}")
    if bgids.device != items.device:
        raise ValueError(f"{what}: inputs on different devices")
    if not 0 <= num_groups < 2 ** 31:
        raise ValueError(f"{what}: num_groups {num_groups} out of range")
    return _layout(items.shape[0], bgids.shape[0])


def cta_blocks(nb: int, sms: int) -> int:
    """Blocks per CTA of the segment_countmin kernel: ``nb`` blocks cut
    into at most ``sms * CTAS_PER_SM`` contiguous ranges of equal length
    (the last may be shorter)."""
    return max(1, -(-nb // (sms * CTAS_PER_SM)))


def segment_countmin(items, valid, bgids, *, depth: int, width: int,
                     num_groups: int):
    """(N2,) items, (N2,) bool valid, (nb,) bgids -> (G, depth, width)
    int32 Count-Min stack (fold-from-zero)."""
    global segment_countmin_launches
    bs = _check_sketch("segment_countmin", items, valid, bgids, num_groups)
    _check_rows(depth, "segment_countmin: depth")
    if width < 1 or num_groups * depth * width >= 2 ** 31:
        raise ValueError(f"segment_countmin: (G, depth, width) = "
                         f"({num_groups}, {depth}, {width}) is out of range")
    route = kernel_route(items, "segment_countmin")
    if route == "cpu":
        return segment_countmin_ref(items, valid, bgids, depth=depth,
                                    width=width, num_groups=num_groups)
    if route == "meta":
        return items.new_empty((num_groups, depth, width), dtype=torch.int32)
    nb = bgids.shape[0]
    if max(nb, bs) >= 2 ** 31:
        raise ValueError("segment_countmin: too many blocks or rows per "
                         "block for the kernel's int arguments")
    out = torch.empty((num_groups, depth, width), dtype=torch.int32,
                      device=items.device)
    words = item_words(items)
    valid, bgids = valid.contiguous(), bgids.contiguous()
    stream = torch.cuda.current_stream(items.device).cuda_stream
    per = cta_blocks(nb, sm_count(items.device.index))
    err = _build.lib().madlib_segment_countmin(
        words.data_ptr(), valid.data_ptr(), bgids.data_ptr(), out.data_ptr(),
        nb, bs, depth, width, num_groups, per, stream)
    _build.check("segment_countmin", err)
    segment_countmin_launches += 1
    return out


def segment_fm(items, valid, bgids, *, num_hashes: int, bits: int,
               num_groups: int):
    """(N2,) items, (N2,) bool valid, (nb,) bgids -> (G, H, bits) int32
    {0,1} Flajolet-Martin stack (fold-from-zero)."""
    global segment_fm_launches
    bs = _check_sketch("segment_fm", items, valid, bgids, num_groups)
    _check_rows(num_hashes, "segment_fm: num_hashes")
    if bits < 1 or num_groups * num_hashes * bits >= 2 ** 31:
        raise ValueError(f"segment_fm: (G, H, bits) = ({num_groups}, "
                         f"{num_hashes}, {bits}) is out of range")
    route = kernel_route(items, "segment_fm")
    if route == "cpu":
        return segment_fm_ref(items, valid, bgids, num_hashes=num_hashes,
                              bits=bits, num_groups=num_groups)
    if route == "meta":
        return items.new_empty((num_groups, num_hashes, bits),
                               dtype=torch.int32)
    nb = bgids.shape[0]
    if max(nb, bs) >= 2 ** 31:
        raise ValueError("segment_fm: too many blocks or rows per block "
                         "for the kernel's int arguments")
    out = torch.empty((num_groups, num_hashes, bits), dtype=torch.int32,
                      device=items.device)
    words = item_words(items, saturate_floats=True)
    valid, bgids = valid.contiguous(), bgids.contiguous()
    stream = torch.cuda.current_stream(items.device).cuda_stream
    err = _build.lib().madlib_segment_fm(
        words.data_ptr(), valid.data_ptr(), bgids.data_ptr(), out.data_ptr(),
        nb, bs, num_hashes, bits, num_groups, stream)
    _build.check("segment_fm", err)
    segment_fm_launches += 1
    return out
