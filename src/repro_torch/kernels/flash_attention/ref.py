"""Plain PyTorch versions of the flash_attention kernel (counterpart of the
reference package's ``kernels/flash_attention/ref.py``) and of its
backward, which the reference package does not have."""

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True,
                  return_lse: bool = False):
    """q (B, Hq, S, D), k/v (B, Hk, S, D) -> (B, Hq, S, D) in q's dtype.

    f32 compute, ``-1e30`` mask, K/V heads repeated to the query heads
    (query head h reads KV head h // (Hq / Hk)).  ``return_lse=True``
    also gives each row's ``torch.logsumexp`` of the same f32 logits,
    (B, Hq, S) f32: ``(out, lse)``."""
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
    lse = torch.logsumexp(logits, -1) if return_lse else None
    w = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    w = w / torch.sum(w, -1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vx).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, return_lse: bool = False):
    """:func:`attention_ref` at the wrapper's scale ``1 / sqrt(D)``: the
    plain version with the wrapper's signature."""
    return attention_ref(q, k, v, scale=1.0 / (q.shape[-1] ** 0.5),
                         causal=causal, return_lse=return_lse)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, lse=None, *,
                            causal: bool = True):
    """The plain version of the backward kernel: the gradients (dq, dk, dv)
    of :func:`flash_attention_ref` given its output ``out`` and the
    output's gradient ``dout``, in explicit formulas, in f32.  It takes the
    wrapper's ``lse`` argument and does not read it: it recomputes the
    softmax itself, an oracle independent of the forward's log-sum-exp:

        P = softmax(q k^T * scale)  (recomputed; masked entries 0)
        dV = P^T dO;  dP = dO V^T;  dS = P o (dP - rowsum(dO o O))
        dQ = dS K * scale;  dK = dS^T Q * scale

    dK and dV are summed over each KV head's group of query heads.  The
    results come back in the inputs' dtypes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, hq, s, d = q.shape
    hk = k.shape[1]
    group = hq // hk
    scale = 1.0 / (d ** 0.5)
    f32 = torch.float32
    qf, dof = q.to(f32), dout.to(f32)
    kx = torch.repeat_interleave(k, group, dim=1).to(f32)
    vx = torch.repeat_interleave(v, group, dim=1).to(f32)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kx) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, torch.tensor(
            -1e30, dtype=f32, device=q.device))
    p = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    del logits
    p = p / torch.sum(p, -1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    delta = torch.sum(dof * out.to(f32), -1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, hk, group, s, d).sum(2)
    dv = dv.reshape(b, hk, group, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
