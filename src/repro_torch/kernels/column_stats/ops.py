"""PyTorch wrapper of the CUDA column_stats kernels
(``csrc/column_stats.cu``).

On a CUDA tensor it checks the inputs and launches the kernel pair, or
raises; on a CPU tensor it runs the plain version in ``ref.py``; on a meta
tensor it returns outputs of the kernel's shapes and launches nothing.
``column_stats_launches`` counts the calls that launch on the card.
:func:`cost` is the work of one call.  Given a running profile state, the
reduce kernel folds the block into it, so a transition is one call.

The kernel reads a column where it lies: a (N, ...) column is viewed as
(N, K) with K the trailing dims' product, and its row and column strides
go to the kernel, so a row slice or a transposed view is not copied.
One kernel family takes every width.  :func:`layout` picks, from K and
whether 16-byte loads are possible, the thread mapping of a CTA (column
groups of 4 or 1 columns across, row lanes down); :func:`splits` picks
the grid from n and the card's SM count, and shrinks it for small blocks,
so many small launches (grouped and streamed profiles) do not each pay
for a grid that fills the card.
"""

from __future__ import annotations

import functools
import math

import torch

from ...device import kernel_route
from .. import _build
from .ref import column_stats_ref

# launches of the kernel pair (partial + fixed-order reduce)
column_stats_launches = 0

_THREADS = 256       # a partial CTA: column groups x row lanes, at most
_CTAS_PER_SM = 4     # partial CTAs resident on an SM (__launch_bounds__)
# rows a lane takes at least before the grid grows past one CTA: below it
# a launch over few rows would spread them thinner than a load ring
_MIN_LANE_ROWS = 32
# the running state's values, in the order of the C entry's pointers
STATS = ("sum", "sumsq", "min", "max", "count")


def _width(col: torch.Tensor) -> int:
    """Values a row: 1 for a 1-D column, the trailing dims' product."""
    return math.prod(col.shape[1:])


def _check(col: torch.Tensor, mask: torch.Tensor, state) -> None:
    if col.dim() < 1:
        raise ValueError("column_stats: want a column (N, ...), got a "
                         "scalar")
    if col.dtype != torch.float32:
        raise TypeError(f"column_stats: want float32, got {col.dtype}")
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or mask.shape[0] != col.shape[0]:
        raise ValueError(f"column_stats: want a bool mask ({col.shape[0]},),"
                         f" got {mask.dtype} {tuple(mask.shape)}")
    if mask.device != col.device:
        raise ValueError(f"column_stats: column on {col.device}, mask on "
                         f"{mask.device}")
    if _width(col) < 1:
        raise ValueError("column_stats: a row must hold at least one value")
    if state is not None:
        for key in STATS:
            t, want = state[key], () if key == "count" else col.shape[1:]
            if t.dtype != torch.float32 or t.shape != want \
                    or t.device != col.device:
                raise ValueError(
                    f"column_stats: state {key!r} must be float32 of shape "
                    f"{tuple(want)} on {col.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")


def layout(k: int, vec: bool) -> tuple[int, int, int]:
    """(column groups, row lanes, column tiles) of the partial kernel for
    width ``k``: groups of 4 columns (16-byte loads) when ``vec``, else of
    1; as many groups across a CTA as the width has, up to ``_THREADS``,
    and the rest of the CTA's threads as row lanes (k = 320: 80 groups, 3
    lanes; k = 1: 256 lanes); tiles of the groups across ``grid.y`` past
    ``_THREADS`` groups."""
    cols = -(-k // (4 if vec else 1))
    groups = min(cols, _THREADS)
    return groups, _THREADS // groups, -(-cols // groups)


def splits(n: int, lanes: int, tiles: int,
           sm_count: int) -> tuple[int, int]:
    """(CTAs, rows a CTA) over n rows: one wave of ``_CTAS_PER_SM`` CTAs an
    SM (shared among the column tiles), fewer where a lane would get under
    ``_MIN_LANE_ROWS`` rows; every CTA gets rows."""
    wave = max(1, _CTAS_PER_SM * sm_count // tiles)
    ctas = max(1, min(wave, -(-n // (lanes * _MIN_LANE_ROWS))))
    rows = max(1, -(-n // ctas))
    return max(1, -(-n // rows)), rows


def column_stats_cost(n: int, k: int,
                      fold: bool = False) -> tuple[float, float]:
    """(operations, bytes) over n rows of k columns: per value a product
    and a sum (sum), two products and a sum (sumsq), a min and a max, and
    an add a row for the count; the column (f32) and the mask (bool) read
    once, the 4 k + 1 results written once.  With ``fold``, the running
    state's 4 k + 1 values are read and each added to."""
    ops, nbytes = 7.0 * n * k + n, 4.0 * n * k + n + 4.0 * (4 * k + 1)
    if fold:
        ops, nbytes = ops + 4 * k + 1, nbytes + 4.0 * (4 * k + 1)
    return ops, nbytes


def cost(col: torch.Tensor, mask: torch.Tensor,
         state=None) -> tuple[float, float]:
    return column_stats_cost(col.shape[0], _width(col), state is not None)


@functools.lru_cache(maxsize=4096)
def _plan(n: int, k: int, vec: bool,
          device: int) -> tuple[int, int, int, int, int]:
    """(groups, lanes, tiles, CTAs, rows a CTA) of one launch on card
    ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups, lanes, tiles = layout(k, vec)
    return (groups, lanes, tiles, *splits(n, lanes, tiles, sms))


def _launch(col: torch.Tensor, mask: torch.Tensor, state):
    """Launch the kernel pair on the card; no counter moves."""
    n, k, shape = col.shape[0], _width(col), col.shape[1:]
    if col.dim() > 2:
        # a view where the trailing dims are one stride apart
        col = col.reshape(n, k)
    stride = col.stride(0)
    cstride = col.stride(1) if col.dim() == 2 else 1
    ptr = col.data_ptr()
    vec = cstride == 1 and k % 4 == 0 and stride % 4 == 0 and ptr % 16 == 0
    device = col.get_device()
    groups, lanes, tiles, ctas, rows = _plan(n, k, vec, device)
    out = col.new_empty((4 * k + 1,))
    work = col.new_empty((ctas * (4 * k + 1),))
    if state is None:
        prior = (None,) * 5
    else:
        # kept until the launch is queued
        held = [state[key].contiguous() for key in STATS]
        prior = [t.data_ptr() for t in held]
    err = _build.lib().madlib_column_stats(
        ptr, mask.data_ptr(), work.data_ptr(), out.data_ptr(), *prior, n, k,
        stride, cstride, mask.stride(0), int(vec), groups, lanes, tiles, ctas,
        rows, torch._C._cuda_getCurrentRawStream(device))
    _build.check("column_stats", err)
    return (out[4 * k], *out[:4 * k].view((4, *shape)).unbind(0))


def column_stats(col: torch.Tensor, mask: torch.Tensor, state=None):
    """(N, ...) f32 column, (N,) bool mask -> (count, sum, sumsq, min, max)
    of the valid rows, f32, as :func:`column_stats_ref`: count a scalar,
    the others of ``col.shape[1:]``; folded into ``state`` (a running
    profile state's five values) when given."""
    global column_stats_launches
    _check(col, mask, state)
    route = kernel_route(col, "column_stats")
    if route == "cpu":
        return column_stats_ref(col, mask, state)
    if route == "meta":
        return (col.new_empty(()),
                *(col.new_empty(col.shape[1:]) for _ in range(4)))
    out = _launch(col, mask, state)
    column_stats_launches += 1
    return out
