"""The control's precision: float32 values rounded to TF32 (10 mantissa
bits, round to nearest even), and matrix products with TF32 on.

On the card a control product is ``torch.matmul`` with TF32 allowed, as
a tensor-core path would compute it.  The CPU has no TF32, so there the
inputs are rounded to TF32 first and multiplied in float32.
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    b = x.contiguous().view(torch.int32)
    r = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """``torch.matmul`` on the card with TF32 on (the control) or off (the
    reference and the data); restores the previous setting."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def gram(a: torch.Tensor, b: torch.Tensor, *, tf32: bool) -> torch.Tensor:
    """``a.T @ b`` of float32 blocks: in float64 for the reference, with
    TF32 for the control."""
    if not tf32:
        with matmul_precision(False):
            return a.double().T @ b.double()
    if a.is_cuda:
        with matmul_precision(True):
            return a.T @ b
    return round_tf32(a).T @ round_tf32(b)
