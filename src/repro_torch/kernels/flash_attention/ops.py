"""PyTorch wrapper of the CUDA flash_attention kernels.

Two hand-written kernels compute the same function; the wrapper picks one
by dtype, head dimension D and layout (:func:`kernel_for`), never by
trying one and falling back:

* bfloat16 that TMA can read -> the tensor-core kernel
  ``csrc/flash_attention_tc.cu`` (wgmma, TMA).  TMA reads rows through
  16-byte strides: D % 8 == 0 (every D of the repo's configs: 16, 64, 96,
  128), every data pointer 16-byte aligned and every batch, head and
  position stride a multiple of 8 elements.
* float32 (any D), and every other bfloat16 input -> the FFMA kernel
  ``csrc/flash_attention.cu``, which reads any strides.

On a CPU tensor the wrapper runs the plain version in ``ref.py``; on a
meta tensor it returns outputs of the kernels' shapes (the log-sum-exp
and the backward's scratch included) and launches nothing.
:func:`forward_cost` and :func:`backward_cost` are the work of one call,
which the bound, the dry run and the op counter on the card all read.
``flash_attention_launches`` counts every launch of either kernel;
``flash_attention_tc_launches`` and ``flash_attention_ffma_launches``
count each kernel's own.

Gradients: where an input requires one, :func:`flash_attention` runs
through :class:`FlashAttentionFn`, which asks the forward kernel for each
row's log-sum-exp and saves it; its backward dispatches
``flash_attention_bwd``: on CUDA tensors :func:`flash_attention_bwd`,
which picks between two hand-written backwards by the forward's rule
(:func:`kernel_for`): ``csrc/flash_attention_bwd_tc.cu`` (wgmma, TMA) or
the FFMA kernels of ``csrc/flash_attention_bwd.cu``, counted in
``flash_attention_bwd_tc_launches`` and
``flash_attention_bwd_ffma_launches`` and their sum
``flash_attention_bwd_launches``; ``flash_attention_bwd_ref`` on CPU
tensors.  Where none requires one, nothing is saved, no log-sum-exp is
written, and the forward is the serving call as it was.

The layout is the reference wrapper's: q (B, Hq, S, D), k and v
(B, Hk, S, D), the result (B, Hq, S, D).  Unlike the reference there is
no tile choice and no padding: the kernels mask the ragged S edge
themselves, so any S is taken.  They read the inputs through their batch,
head and position strides, so a ``(B, S, H, D)`` tensor seen through
``transpose(1, 2)`` needs no copy; the result is laid out like q.
"""

from __future__ import annotations

import torch

from ...device import kernel_route
from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

flash_attention_launches = 0
flash_attention_tc_launches = 0
flash_attention_ffma_launches = 0
flash_attention_bwd_launches = 0
flash_attention_bwd_tc_launches = 0
flash_attention_bwd_ffma_launches = 0

MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_ALIGN = 16   # bytes: TMA's rule for pointers and strides
ROW_PAD = 64      # the tensor-core backward's row scratch pads S to this


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


def tma_strides(t: torch.Tensor) -> list[int] | None:
    """The batch, head and position strides of ``t`` as the tensor-core
    kernel is given them: an axis of size 1 is never stepped, so it gets
    a contiguous tensor's stride, which is a multiple of 8 elements when D
    is.  None when a stride that is used, or the data pointer, breaks
    TMA's 16-byte rule."""
    _, h, s, d = t.shape
    dense = (h * s * d, s * d, d)
    out = [dense[i] if t.shape[i] == 1 else t.stride(i) for i in range(3)]
    per = _TMA_ALIGN // t.element_size()
    if any(s % per for s in out) or t.data_ptr() % _TMA_ALIGN:
        return None
    return out


def kernel_for(*tensors: torch.Tensor) -> str:
    """Which CUDA kernel takes ``tensors`` (q, k, v and the output; for the
    backward also the output's gradient):
    ``"tc"`` (tensor cores) for bfloat16 with D % 8 == 0 that TMA can read
    (:func:`tma_strides`), else ``"ffma"``."""
    t0 = tensors[0]
    if t0.dtype != torch.bfloat16 or t0.shape[-1] % 8:
        return "ffma"
    if any(tma_strides(t) is None for t in tensors):
        return "ffma"
    return "tc"


def _pairs(s: int, causal: bool) -> float:
    """The unmasked (query, key) pairs of one head: S (S + 1) / 2 causal,
    S^2 not."""
    return s * (s + 1) / 2 if causal else float(s) * s


def forward_cost(b, hq, hk, s, d, causal: bool = True, elt_bytes: int = 2
                 ) -> tuple[float, float]:
    """(operations, bytes) of attention at (B, Hq, Hk, S, D): 4 B Hq D P
    operations (the two products over the P unmasked pairs), q and o, k
    and v each read or written once at ``elt_bytes`` an element."""
    return (4.0 * b * hq * d * _pairs(s, causal),
            elt_bytes * (2.0 * b * hq * s * d + 2.0 * b * hk * s * d))


def backward_cost(b, hq, hk, s, d, causal: bool = True, elt_bytes: int = 2
                  ) -> tuple[float, float]:
    """(operations, bytes) of the attention backward: its five products
    are 2.5 x the forward's operations; q, k, v, o and dO read once and
    dq, dk, dv written once at ``elt_bytes`` an element."""
    return (2.5 * 4.0 * b * hq * d * _pairs(s, causal),
            elt_bytes * (4.0 * b * hq * s * d + 4.0 * b * hk * s * d))


def cost(q, k, v, *, causal: bool = True, return_lse: bool = False):
    b, hq, s, d = q.shape
    return forward_cost(b, hq, k.shape[1], s, d, causal, q.element_size())


def bwd_cost(q, k, v, out, dout, lse, *, causal: bool = True):
    b, hq, s, d = q.shape
    return backward_cost(b, hq, k.shape[1], s, d, causal, q.element_size())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q (B, Hq, S, D), k/v (B, Hk, S, D) -> (B, Hq, S, D) in q's dtype:
    softmax(q k^T / sqrt(D)) v, causal unless ``causal=False``, query head
    h reading KV head h // (Hq / Hk).  Differentiable in q, k and v.

    ``return_lse=True`` gives ``(out, lse)`` with each row's log-sum-exp
    of the scaled, masked scores, f32 (B, Hq, S), natural log; ``out`` is
    the same bits as without it.  That call records no graph, so it
    raises where an input requires a gradient under grad mode."""
    _check(q, k, v)
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if return_lse:
        if wants_grad:
            raise ValueError("flash_attention: return_lse=True records no "
                             "gradient; call it under torch.no_grad() or "
                             "on inputs that require none")
        return _forward(q, k, v, causal, with_lse=True)
    if wants_grad:
        return FlashAttentionFn.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  Saves
    q, k, v, the output and the forward's log-sum-exp (f32, B Hq S); under
    activation checkpointing those are dropped and the forward runs again,
    log-sum-exp and all, before the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        from ..registry import dispatch
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = dispatch("flash_attention_bwd", q, k, v, out, dout, lse,
                              causal=ctx.causal)
        return dq, dk, dv, None


def _forward(q, k, v, causal: bool, with_lse: bool = False):
    """The forward on q's device: the kernel chosen by :func:`kernel_for`
    on the card, the plain version on the CPU.  ``with_lse`` also returns
    the log-sum-exp that the kernel's epilogue writes (none is written
    without it)."""
    global flash_attention_launches, flash_attention_tc_launches
    global flash_attention_ffma_launches
    route = kernel_route(q, "flash_attention")
    if route == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   return_lse=with_lse)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the feature axis of q, k and v "
                         "must have stride 1")
    b, hq, s, d = q.shape
    out = torch.empty_like(q)      # q's strides where q is dense
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if route == "meta" or out.numel() == 0:
        return (out, lse) if with_lse else out
    lse_ptr = None if lse is None else lse.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / (d ** 0.5)
    if kernel_for(q, k, v, out) == "tc":
        strides = [st for t in (q, k, v, out) for st in tma_strides(t)]
        err = _build.lib().madlib_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, b, hq, k.shape[1], s, d, *strides, scale, int(causal),
            stream)
        _build.check("flash_attention_tc", err)
        flash_attention_tc_launches += 1
    else:
        err = _build.lib().madlib_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, _DTYPES[q.dtype], b, hq, k.shape[1], s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], scale, int(causal), stream)
        _build.check("flash_attention", err)
        flash_attention_ffma_launches += 1
    flash_attention_launches += 1
    return (out, lse) if with_lse else out


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    b, hq, s, _ = q.shape
    if (not isinstance(lse, torch.Tensor) or lse.shape != (b, hq, s)
            or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        got = (f"{tuple(lse.shape)} {lse.dtype} on {lse.device}"
               if isinstance(lse, torch.Tensor) else type(lse).__name__)
        raise ValueError(f"flash_attention_bwd: lse {got}, want the "
                         f"forward's contiguous float32 {(b, hq, s)} on "
                         f"{q.device}")


def bwd_kernel_for(q, k, v, out, dout, lse) -> str:
    """Which backward takes these inputs on the card: ``"tc"`` where the
    forward's rule (:func:`kernel_for`) sends q, k, v, out and dout to
    the tensor cores and lse starts 16-byte aligned, else ``"ffma"``.  The
    gradients are laid out like q, k and v, so they pass where those do."""
    if lse.data_ptr() % _TMA_ALIGN or kernel_for(q, k, v, out, dout) != "tc":
        return "ffma"
    return "tc"


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at q, k, v
    given its output ``out``, that output's gradient ``dout`` (both shaped
    like q) and the forward's log-sum-exp ``lse`` (f32, (B, Hq, S), from
    ``flash_attention(..., return_lse=True)``), each gradient laid out
    like its input.  On the card one call launches the three kernels of
    the backward that :func:`bwd_kernel_for` picks (rows, dK/dV, dQ) on
    the current stream, with an f32 scratch for the rows' delta (and, for
    the tensor cores, lse in base 2 beside it).  On the CPU it runs the
    plain version, which recomputes the softmax and reads no lse.  On
    meta tensors it allocates what the card's call allocates (the
    gradients and the scratch) and launches nothing."""
    global flash_attention_bwd_launches, flash_attention_bwd_tc_launches
    global flash_attention_bwd_ffma_launches
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want q's {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}")
    _check_lse(q, lse)
    route = kernel_route(q, "flash_attention_bwd")
    if route == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, causal=causal)
    if any(t.stride(-1) != 1 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: the feature axis of q, k, v, "
                         "out and dout must have stride 1")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    b, hq, s, d = q.shape
    tensors = (q, k, v, out, dout, dq, dk, dv)
    if bwd_kernel_for(q, k, v, out, dout, lse) == "tc":
        s_pad = -(-s // ROW_PAD) * ROW_PAD
        rows = torch.empty((2, b, hq, s_pad), dtype=torch.float32,
                           device=q.device)
        if route == "meta":
            return dq, dk, dv
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = [t.data_ptr() for t in tensors]
        err = _build.lib().madlib_flash_attention_bwd_tc(
            *ptrs, lse.data_ptr(), rows.data_ptr(), b, hq, k.shape[1], s, d,
            *(st for t in tensors for st in tma_strides(t)),
            1.0 / (d ** 0.5), int(causal), stream)
        _build.check("flash_attention_bwd_tc", err)
        flash_attention_bwd_tc_launches += 1
    else:
        delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
        if route == "meta":
            return dq, dk, dv
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = [t.data_ptr() for t in tensors]
        err = _build.lib().madlib_flash_attention_bwd(
            *ptrs, lse.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype], b, hq,
            k.shape[1], s, d, *(st for t in tensors for st in t.stride()[:3]),
            1.0 / (d ** 0.5), int(causal), stream)
        _build.check("flash_attention_bwd", err)
        flash_attention_bwd_ffma_launches += 1
    flash_attention_bwd_launches += 1
    return dq, dk, dv
