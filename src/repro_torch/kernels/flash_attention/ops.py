"""PyTorch wrapper of the CUDA flash_attention kernel
(``csrc/flash_attention.cu``).

On a CUDA tensor it checks the inputs and launches the kernel, or
raises; on a CPU tensor it runs the plain version in ``ref.py``.
``flash_attention_launches`` counts the wrapper's calls that launch the
kernel.

The layout is the reference wrapper's: q (B, Hq, S, D), k and v
(B, Hk, S, D), the result (B, Hq, S, D).  Unlike the reference there is
no tile choice and no padding: the kernel masks the ragged S edge itself,
so any S is taken.  It reads the inputs through their batch, head and
position strides, so a ``(B, S, H, D)`` tensor seen through
``transpose(1, 2)`` needs no copy; the result is laid out like q.
"""

from __future__ import annotations

import torch

from ...device import runs_on_card
from .. import _build
from .ref import flash_attention_ref

flash_attention_launches = 0

MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, Hq, S, D), k and v "
                         f"(B, Hk, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} differ in B, S or D")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: want float32 or bfloat16 alike, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    hk = k.shape[1]
    if hk == 0 or hq % hk != 0:
        raise ValueError(f"flash_attention: Hq = {hq} is not a multiple of "
                         f"Hk = {hk}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention: D = {d} must lie in "
                         f"[1, {MAX_D}]")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hk, S, D) -> (B, Hq, S, D) in q's dtype:
    softmax(q k^T / sqrt(D)) v, causal unless ``causal=False``, query head
    h reading KV head h // (Hq / Hk)."""
    global flash_attention_launches
    _check(q, k, v)
    if not runs_on_card(q, "flash_attention"):
        return flash_attention_ref(q, k, v, causal=causal)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the feature axis of q, k and v "
                         "must have stride 1")
    b, hq, s, d = q.shape
    out = torch.empty_like(q)      # q's strides where q is dense
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().madlib_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, k.shape[1], s, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], 1.0 / (d ** 0.5), int(causal), stream)
    _build.check("flash_attention", err)
    flash_attention_launches += 1
    return out
