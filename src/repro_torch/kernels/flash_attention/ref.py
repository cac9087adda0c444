"""Plain PyTorch version of the flash_attention kernel (counterpart of the
reference package's ``kernels/flash_attention/ref.py``)."""

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hk, S, D) -> (B, Hq, S, D) in q's dtype.

    f32 compute, ``-1e30`` mask, K/V heads repeated to the query heads
    (query head h reads KV head h // (Hq / Hk))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s = q.shape[2]
    group = q.shape[1] // k.shape[1]
    kx = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vx = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kx) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, torch.tensor(
            -1e30, dtype=torch.float32, device=q.device))
    w = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    w = w / torch.sum(w, -1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", w, vx).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """:func:`attention_ref` at the wrapper's scale ``1 / sqrt(D)``: the
    plain version with the wrapper's signature."""
    return attention_ref(q, k, v, scale=1.0 / (q.shape[-1] ** 0.5),
                         causal=causal)
