"""Optimizers over dicts of tensors: AdamW and SGD with momentum, with f32
moments beside bf16 (or f32) parameters, and clipping by the global norm.

Counterpart of the reference package's ``optim/optimizers.py``.  The
optimizer is the ``final`` function of the gradient aggregate: the
trainer's transition is one micro-batch's gradient, its merge the sum.
The arithmetic is the reference's, leaf by leaf, in f32; where the
reference returns new trees, these functions update the parameters,
moments and gradients IN PLACE (a 1.6 B-parameter model's f32 moments
are 13 GB: a second copy would not fit beside them) and return them.
The moments move with ``torch._foreach_*`` over all leaves at once.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamWState:
    """First and second moments (f32, keyed like the parameters) and the
    0-d int32 count of updates made."""

    mu: dict
    nu: dict
    count: torch.Tensor


def _f32_zeros(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def adamw_init(params: dict) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(_f32_zeros(params), _f32_zeros(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step, in place: m = b1 m + (1 - b1) g and v = b2 v +
    (1 - b2) g g in f32, bias-corrected by 1 - b^t, then p -= lr (m_hat /
    (sqrt(v_hat) + eps) + weight_decay p), the decay on p in f32 and the
    result cast back to p's dtype.  ``lr`` is a float or a 0-d tensor.
    Returns (params, state)."""
    keys = list(params)
    g32 = [grads[k].to(torch.float32) for k in keys]
    mu = [state.mu[k] for k in keys]
    nu = [state.nu[k] for k in keys]
    state.count += 1
    t = state.count.to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g32, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g32, g32, value=1 - b2)
    del g32
    for k, m, v in zip(keys, mu, nu):
        p = params[k]
        p32 = p.to(torch.float32)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        p.copy_(p32 - lr * step)
    return params, state


def sgdm_init(params: dict) -> dict:
    return _f32_zeros(params)


def sgdm_update(grads: dict, momentum: dict, params: dict, *, lr,
                beta=0.9):
    """m = beta m + g (f32), p -= lr m cast back to p's dtype; in place.
    Returns (params, momentum)."""
    for k, p in params.items():
        m = momentum[k]
        m.mul_(beta).add_(grads[k].to(torch.float32))
        p.copy_(p.to(torch.float32) - lr * m)
    return params, momentum


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)), norm
    the f32 L2 norm over all leaves (the per-leaf sums of squares added
    in the leaves' order), each product cast back to its gradient's dtype;
    in place.  Returns (grads, norm)."""
    total = None
    for g in grads.values():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return grads, norm
