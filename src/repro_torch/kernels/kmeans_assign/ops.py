"""PyTorch wrapper of the CUDA kmeans_assign kernel
(``csrc/kmeans_assign.cu``).

On a CUDA tensor it checks the inputs and launches the kernel, or
raises; on a CPU tensor it runs the plain version in ``ref.py``; on a
meta tensor it returns outputs of the kernel's shapes and launches
nothing (:func:`cost` is the work of one call).
``kmeans_assign_launches`` counts the wrapper's calls that launch the
kernel pair (the assign-and-partial pass and the fixed-order reduce).

Unlike the reference's wrapper there is no padding: the TPU layout of
K to 8 (with a 1e15 sentinel) and D to 128 lanes has no counterpart
here, and the kernel takes any K and D up to the limits below.
"""

from __future__ import annotations

import torch

from ...device import kernel_route
from .. import _build
from .ref import assign_and_reduce_ref

kmeans_assign_launches = 0

TILE_ROWS = 256            # rows per CTA step in the kernel
MAX_K = 4096               # centroid norms live in shared memory
MAX_D = 4096
# scratch for the per-CTA partial sums and counts, at most
SCRATCH_BYTES = 128 << 20
# the kernel's CTAs resident on an SM at the main shape (76 KB of shared
# memory each, its two-stage ring of 256-row tiles most of it)
CTAS_PER_SM = 3


def _check(x: torch.Tensor, c: torch.Tensor, m: torch.Tensor) -> None:
    if x.dim() != 2 or c.dim() != 2 or m.dim() != 1:
        raise ValueError(f"kmeans_assign: want x (N, D), c (K, D), m (N,), "
                         f"got {tuple(x.shape)}, {tuple(c.shape)}, "
                         f"{tuple(m.shape)}")
    if c.shape[1] != x.shape[1] or m.shape[0] != x.shape[0]:
        raise ValueError(f"kmeans_assign: shapes disagree: x "
                         f"{tuple(x.shape)}, c {tuple(c.shape)}, m "
                         f"{tuple(m.shape)}")
    if any(t.dtype != torch.float32 for t in (x, c, m)):
        raise TypeError(f"kmeans_assign: want float32, got {x.dtype}, "
                        f"{c.dtype}, {m.dtype}")
    if c.device != x.device or m.device != x.device:
        raise ValueError(f"kmeans_assign: x on {x.device}, c on {c.device}, "
                         f"m on {m.device}")
    if not (x.is_contiguous() and c.is_contiguous() and m.is_contiguous()):
        raise ValueError("kmeans_assign: x, c and m must be contiguous")
    k, d = c.shape
    if not (1 <= k <= MAX_K and 1 <= d <= MAX_D):
        raise ValueError(f"kmeans_assign: K = {k} and D = {d} must lie in "
                         f"[1, {MAX_K}] and [1, {MAX_D}]")


def scratch_floats(k: int, d: int) -> int:
    """Scratch per CTA: a row bitmap word per centroid and 32-row group of
    a tile, the partial sums ``(K, D)`` and counts ``(K,)``, padded to 16
    bytes (the kernel's ``scratch_floats``)."""
    return ((TILE_ROWS // 32) * k + k * d + k + 3) // 4 * 4


def splits_for(n: int, k: int, d: int, sm_count: int) -> int:
    """CTAs of the persistent assign pass: enough to fill the card, no
    more than the row tiles, and few enough that their scratch fits in
    ``SCRATCH_BYTES``."""
    tiles = -(-n // TILE_ROWS)
    cap = max(1, SCRATCH_BYTES // (4 * scratch_floats(k, d)))
    return max(1, min(tiles, CTAS_PER_SM * sm_count, cap))


def assign_cost(n: int, d: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of one call: a multiply and an add per row,
    centroid and feature (f32); x and the mask read, assign and mind
    written, the centroids read and the sums and counts written."""
    return (2.0 * n * k * d,
            4.0 * n * d + 12.0 * n + 8.0 * k * d)


def cost(x: torch.Tensor, c: torch.Tensor, m: torch.Tensor
         ) -> tuple[float, float]:
    return assign_cost(x.shape[0], x.shape[1], c.shape[0])


def assign_and_reduce(x: torch.Tensor, c: torch.Tensor, m: torch.Tensor):
    """x (N,D), centroids c (K,D), mask m (N,) f32 -> (assign (N,) int32,
    mind (N,), sums (K,D), counts (K,)) f32.  ``assign`` is the nearest
    centroid (lowest index among ties) of every row, masked or not;
    ``mind`` is ``max(min d^2, 0) * m``; the sums and counts add ``m``
    times each row into its centroid."""
    global kmeans_assign_launches
    _check(x, c, m)
    route = kernel_route(x, "kmeans_assign")
    if route == "cpu":
        return assign_and_reduce_ref(x, c, m)
    n, d = x.shape
    k = c.shape[0]
    dev = x.device
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    mind = torch.empty((n,), dtype=torch.float32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    if route == "meta":
        return assign, mind, sums, counts
    if n == 0:
        return assign, mind, sums.zero_(), counts.zero_()
    props = torch.cuda.get_device_properties(dev)
    splits = splits_for(n, k, d, props.multi_processor_count)
    partials = torch.empty((splits, scratch_floats(k, d)),
                           dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().madlib_kmeans_assign(
        x.data_ptr(), c.data_ptr(), m.data_ptr(), assign.data_ptr(),
        mind.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        counts.data_ptr(), n, d, k, splits, stream)
    _build.check("kmeans_assign", err)
    kmeans_assign_launches += 1
    return assign, mind, sums, counts
