"""PyTorch wrapper of the CUDA xtx kernel (``csrc/xtx.cu``).

On a CUDA tensor it checks the inputs and launches the kernel, or
raises; on a CPU tensor it runs the plain version in ``ref.py``; on a
meta tensor it returns outputs of the kernel's shapes and launches
nothing.  ``xtx_launches`` counts the kernel's launches (one per call on
the card).  :func:`cost` is the work of one call, which the bound, the
dry run and the op counter on the card all read.

The kernel computes only the upper triangle of the Gram matrix of
``A = [x | y]``; ``csrc/gram_upper.cuh`` lays out its work units and
micro-tiles (shared with ``segment_linregr``).
:func:`splits_for` chooses its row splits.
"""

from __future__ import annotations

import torch

from ...device import kernel_route
from .. import _build
from .ref import xtx_xty_ref

# launches of the CUDA kernel pair (partial + fixed-order reduce)
xtx_launches = 0

_CHUNK = 32          # rows per staged chunk in the kernel
_TILE = 176          # column tile of [x | y] in the kernel (22 blocks)
_CTAS_PER_SM = 2     # the kernel's 256-thread CTAs resident on an SM
# rows per split at most: bounds each f32 accumulation chain in the kernel
_MAX_SPLIT_ROWS = 8192


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 2 or y.dim() != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(f"xtx: want x (N, K) and y (N,), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"xtx: want float32, got {x.dtype} and {y.dtype}")
    if y.device != x.device:
        raise ValueError(f"xtx: x on {x.device}, y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("xtx: x and y must be contiguous")
    if x.shape[1] < 1:
        raise ValueError("xtx: K must be at least 1")


def splits_for(n: int, k: int, sm_count: int) -> tuple[int, int]:
    """(row splits, rows per split): splits of at most ``_MAX_SPLIT_ROWS``
    rows and at least one staged chunk, as many as fill whole waves of
    ``_CTAS_PER_SM`` CTAs per SM over the kernel's T^2 units of a split
    (T column tiles of ``_TILE``)."""
    t = -(-(k + 1) // _TILE)
    per_wave = max(1, _CTAS_PER_SM * sm_count // (t * t))
    waves = -(-(-(-n // _MAX_SPLIT_ROWS)) // per_wave)
    rows = min(_MAX_SPLIT_ROWS, max(_CHUNK, -(-n // (waves * per_wave))))
    return max(1, -(-n // rows)), rows


def xtx_cost(n: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of X^T X and X^T y over n rows of k variables:
    X^T X is symmetric, so only its k (k + 1) / 2 distinct entries, plus
    the k of X^T y, each a multiply and an add per row (f32); x and y read
    once, X^T X and X^T y written once."""
    return (float(n) * k * (k + 3),
            4.0 * (float(n) * (k + 1) + k * (k + 1)))


def cost(x: torch.Tensor, y: torch.Tensor) -> tuple[float, float]:
    return xtx_cost(*x.shape)


def xtx_xty(x: torch.Tensor, y: torch.Tensor):
    """(N, K), (N,) f32 -> (X^T X (K, K), X^T y (K,)) f32."""
    global xtx_launches
    _check(x, y)
    route = kernel_route(x, "xtx")
    if route == "cpu":
        return xtx_xty_ref(x, y)
    n, k = x.shape
    if route == "meta":
        return (x.new_empty((k, k)), x.new_empty((k,)))
    props = torch.cuda.get_device_properties(x.device)
    splits, rows = splits_for(n, k, props.multi_processor_count)
    w = k + 1
    partials = torch.empty((splits, w, w), dtype=torch.float32,
                           device=x.device)
    xtx = torch.empty((k, k), dtype=torch.float32, device=x.device)
    xty = torch.empty((k,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().madlib_xtx(
        x.data_ptr(), y.data_ptr(), partials.data_ptr(), xtx.data_ptr(),
        xty.data_ptr(), n, k, splits, rows, stream)
    _build.check("xtx", err)
    xtx_launches += 1
    return xtx, xty
