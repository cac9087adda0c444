"""PyTorch wrapper of the CUDA xtx kernels (``csrc/xtx.cu`` and
``csrc/xtx_narrow.cu``).

On a CUDA tensor it checks the inputs and launches a kernel, or raises;
on a CPU tensor it runs the plain version in ``ref.py``; on a meta tensor
it returns outputs of the kernel's shapes and launches nothing.
``xtx_launches`` counts the calls that launch on the card (one per call,
either path), ``xtx_narrow_launches`` those of them that took the narrow
path.  :func:`cost` is the work of one call, which the bound, the dry
run and the op counter on the card all read, whichever path runs.

Both kernels compute only the upper triangle of the Gram matrix of
``A = [x | y]``.  K from 1 to ``K_NARROW`` takes the narrow path
(``csrc/xtx_narrow.cu``: row groups of a CTA each compute the whole
triangle over their own rows; :func:`narrow_layout` and
:func:`narrow_splits` give its plan); wider K takes the wide path
(``csrc/gram_upper.cuh`` lays out its 176-column work units and
micro-tiles, shared with ``segment_linregr``; :func:`splits_for` gives
its row splits).
"""

from __future__ import annotations

import functools

import torch

from ...device import kernel_route
from .. import _build
from .ref import xtx_xty_ref

# launches of a CUDA kernel pair (partial + fixed-order reduce), either
# path; and of them, those of the narrow path
xtx_launches = 0
xtx_narrow_launches = 0

# The widest K that takes the narrow path, from section k of
# chip_smoke.py (both paths and torch.matmul(x.T, x) on 10^7 dyadic rows,
# CUDA events, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, row 1 of the
# kernel table).  Up to K = 120 the micro-tiles leave two row groups a CTA
# and the narrow kernel beats both the wide one and torch.matmul (K = 120:
# 5.557 ms, wide 8.841, matmul 6.072).  From K = 121 one group is left:
# at K = 128 it takes 7.940 ms, under the wide kernel's 8.776 but over
# torch.matmul's 6.072, and at K = 160 the wide kernel is faster (8.707
# against 10.636).
K_NARROW = 120

_CHUNK = 32          # rows per staged chunk in the kernel
_TILE = 176          # column tile of [x | y] in the kernel (22 blocks)
_CTAS_PER_SM = 2     # the kernel's 256-thread CTAs resident on an SM
# rows per split at most: bounds each f32 accumulation chain in the kernel
_MAX_SPLIT_ROWS = 8192
# the narrow kernel (csrc/xtx_narrow.cu): the register triangle up to
# width k + 1 = 16, 256 threads each taking 1, 2, 4 or 8 rows of a chunk;
# past it 8 x 8 micro-tiles, row groups of m threads filling at most 256,
# each group taking 16, 8 or 4 rows of a chunk, as many as let the
# CTA's three stages fit 28,672 floats (two CTAs an SM)
_TRI_MAX_W = 16
_TRI_THREADS = 256
_MT = 8
_MT_THREADS = 256
_MT_STAGES = 3
_MT_SMEM = 28672
_MT_ROWS_PER_GROUP = (16, 8, 4)


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


def narrow_layout(k: int) -> dict:
    """The narrow kernel's CTA for width ``k``, as ``csrc/xtx_narrow.cu``
    lays it out: ``kind`` ("triangle" or "micro"), ``threads``,
    ``groups`` (row groups, each computing the whole upper triangle over
    its own rows of a chunk), ``micro`` (threads a group: one per 8 x 8
    micro-tile over ``blocks`` blocks of 8 of x's columns, the diagonal
    ones also taking y; 1 for the register triangle, where one thread
    holds every entry), ``rows_per_chunk`` (a multiple of ``groups``) and
    ``pitch`` (floats a staged row)."""
    w = k + 1
    if w <= _TRI_MAX_W:
        per_thread = 8 if w <= 2 else 4 if w <= 4 else 2 if w <= 12 else 1
        return {"kind": "triangle", "threads": _TRI_THREADS,
                "groups": _TRI_THREADS, "micro": 1, "blocks": 1,
                "rows_per_chunk": _TRI_THREADS * per_thread,
                "pitch": w | 1}
    c = -(-k // _MT)
    m = c * (c + 1) // 2
    if m > _MT_THREADS:
        raise ValueError(f"xtx: K = {k} is too wide for the narrow kernel")
    groups = _MT_THREADS // m
    pitch = _MT * c + 4
    per_group = next(r for r in _MT_ROWS_PER_GROUP
                     if _MT_STAGES * groups * r * (pitch + 1) <= _MT_SMEM)
    return {"kind": "micro", "threads": m * groups, "groups": groups,
            "micro": m, "blocks": c, "rows_per_chunk": groups * per_group,
            "pitch": pitch}


def narrow_splits(n: int, k: int, sm_count: int,
                  ctas_per_sm: int) -> tuple[int, int]:
    """(row splits, rows per split) of the narrow kernel: whole chunks,
    as many splits as fill whole waves of ``ctas_per_sm`` CTAs per SM,
    and more where a split would make an f32 chain (one group's rows of
    every chunk) longer than ``_MAX_SPLIT_ROWS`` rows."""
    lay = narrow_layout(k)
    r = lay["rows_per_chunk"]
    per_group = r // lay["groups"]           # a chain's rows per chunk
    chunks = max(1, -(-n // r))
    wave = max(1, ctas_per_sm * sm_count)
    fewest = -(-chunks // max(1, _MAX_SPLIT_ROWS // per_group))
    splits = min(chunks, -(-fewest // wave) * wave)
    rows = -(-chunks // splits) * r
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


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(k: int, device: int) -> int:
    """The narrow kernel's CTAs for width ``k`` that fit an SM of card
    ``device``, from the CUDA runtime's occupancy count."""
    lay = narrow_layout(k)
    with torch.cuda.device(device):
        ctas = _build.lib().madlib_xtx_narrow_ctas_per_sm(
            k, lay["groups"], lay["rows_per_chunk"])
    if ctas < 1:
        raise RuntimeError(f"xtx: the narrow kernel for K = {k} fits no SM "
                           f"({ctas})")
    return ctas


@functools.lru_cache(maxsize=4096)
def _plan(n: int, k: int, narrow: bool,
          device: int) -> tuple[int, int, int, int]:
    """(splits, rows per split, groups, rows per chunk) of one launch on
    card ``device`` (groups and rows per chunk 0 on the wide path)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if not narrow:
        return (*splits_for(n, k, sms), 0, 0)
    lay = narrow_layout(k)
    splits, rows = narrow_splits(n, k, sms, _ctas_per_sm(k, device))
    return splits, rows, lay["groups"], lay["rows_per_chunk"]


def _launch(x: torch.Tensor, y: torch.Tensor, narrow: bool):
    """Launch one path's kernels on the card; no counter moves."""
    n, k = x.shape
    device = x.get_device()
    splits, rows, groups, chunk = _plan(n, k, narrow, device)
    w = k + 1
    partials = x.new_empty((splits, w, w))
    xtx = x.new_empty((k, k))
    xty = x.new_empty((k,))
    stream = torch._C._cuda_getCurrentRawStream(device)
    args = (x.data_ptr(), y.data_ptr(), partials.data_ptr(), xtx.data_ptr(),
            xty.data_ptr(), n, k, splits, rows)
    if narrow:
        err = _build.lib().madlib_xtx_narrow(*args, groups, chunk, stream)
    else:
        err = _build.lib().madlib_xtx(*args, stream)
    _build.check("xtx", err)
    return xtx, xty


def xtx_xty(x: torch.Tensor, y: torch.Tensor):
    """(N, K), (N,) f32 -> (X^T X (K, K), X^T y (K,)) f32; on the card
    through the narrow kernel when K <= ``K_NARROW``, else the wide one."""
    global xtx_launches, xtx_narrow_launches
    _check(x, y)
    route = kernel_route(x, "xtx")
    if route == "cpu":
        return xtx_xty_ref(x, y)
    n, k = x.shape
    if route == "meta":
        return (x.new_empty((k, k)), x.new_empty((k,)))
    narrow = k <= K_NARROW
    out = _launch(x, y, narrow)
    xtx_launches += 1
    xtx_narrow_launches += narrow
    return out
