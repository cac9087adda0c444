"""Mixture-of-experts FFN with capacity-factor routing (GShard-style).

Counterpart of the reference package's ``models/moe.py``: tokens are
bucketed per expert up to capacity C by a stable sort over their expert
assignments, gathered into an (E, C, d) tensor, pushed through the
per-expert SwiGLU as batched matmuls, and combined back with the router
weights.  Overflow tokens are dropped (``drop_frac`` in the aux stats).

Two choices keep the port's answers those of the reference on the card:

* top-k goes through a stable descending sort, so tied probabilities
  keep the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order among ties, and bf16 router logits tie often);
* the combine is a gather, not a scatter-add: each token takes its kept
  slots in slot order (expert order) and sums them left to right in the
  output dtype, where the reference's scatter-add sums them.  An atomic
  ``index_add_`` would change the order, and in bf16 the bits, from run
  to run.

:func:`route`, :func:`dispatch` and :func:`combine` are the three steps;
the all-to-all MoE (``distributed/ep_a2a.py``) runs them per shard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..launch.scan_registry import tag_scope
from .layers import NORMAL, param


class MoE(nn.Module):
    """``router`` (d, E); experts ``w_gate``/``w_up`` (E, d, F) and
    ``w_down`` (E, F, d).  The experts' fan-in is their first axis, E, as
    the reference's ``ParamStore.add`` takes it."""

    INIT = {"router": NORMAL, "w_gate": NORMAL, "w_up": NORMAL,
            "w_down": NORMAL}
    AXES = {"router": ("fsdp", None),
            "w_gate": ("expert", "fsdp", "tensor"),
            "w_up": ("expert", "fsdp", "tensor"),
            "w_down": ("expert", "tensor", "fsdp")}

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = param((d, e), dtype, device)
        self.w_gate = param((e, d, f), dtype, device)
        self.w_up = param((e, d, f), dtype, device)
        self.w_down = param((e, f, d), dtype, device)


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def run_moe(p: MoE, cfg, x):
    """x (B, S, d) -> (B, S, d), aux dict {"aux_loss", "drop_frac"} (f32
    scalars).

    When ``cfg.moe_token_chunk`` is set and divides a larger batch, the
    tokens go through the experts in chunks of that many (the capacity is
    then a chunk's), and the aux stats are averaged over the chunks."""
    b, s, d = x.shape
    n = b * s
    chunk = cfg.moe_token_chunk
    if chunk and n > chunk and n % chunk == 0:
        with tag_scope("tagscan_moe_tokens", n // chunk):
            outs, auxs = zip(*[_moe_tokens(p, cfg, xi)
                               for xi in x.reshape(n // chunk, 1, chunk, d)])
        aux = {k: torch.mean(torch.stack([a[k] for a in auxs]))
               for k in auxs[0]}
        return torch.cat(outs).reshape(b, s, d), aux
    return _moe_tokens(p, cfg, x)


def route(logits, k: int):
    """f32 router logits (N, E) -> (probs (N, E), top_p (N, k), top_e (N,
    k)): top-k by a stable descending sort (ties keep the lower expert),
    top_p renormalised over the k."""
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return probs, top_p / torch.sum(top_p, -1, keepdim=True), top_e


def balance_loss(probs, top_e, e: int):
    """The load-balance term ``E * sum(me * ce)`` (Switch/GShard form),
    before ``router_aux_weight``."""
    me = torch.mean(probs, dim=0)                             # (E,)
    ce = torch.mean(torch.sum(F.one_hot(top_e, e).to(torch.float32),
                              dim=1), dim=0)
    return e * torch.sum(me * ce)


def dispatch(top_p, top_e, e: int, cap: int):
    """Sort-based capacity bucketing of (N, k) assignments into E buckets
    of ``cap`` slots.  Returns (tok_ec (E, C) int64, w_ec (E, C) f32,
    valid_ec (E, C) f32, slot_of (N, k)): the token, weight and validity
    of each slot (an empty slot holds token 0 with weight 0), and each
    assignment's slot, ``E * cap`` for one past its bucket (dropped)."""
    n, k = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(-1)                                # (N*k,)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)                # by expert
    se, sp, stok = flat_e[order], flat_p[order], flat_tok[order]
    # position of each assignment within its expert's bucket
    pos_in_e = torch.arange(n * k, device=dev) - torch.searchsorted(
        se, se, side="left")
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)    # overflow slot
    # every kept assignment owns its slot; the dropped ones all write the
    # one slot past the buckets, which is cut off (no boolean indexing:
    # its length would depend on the data, which a meta tensor lacks)
    tok_ec = torch.zeros(e * cap + 1, dtype=torch.long, device=dev)
    w_ec = torch.zeros(e * cap + 1, dtype=torch.float32, device=dev)
    valid_ec = torch.zeros(e * cap + 1, dtype=torch.float32, device=dev)
    tok_ec[slot] = stok
    w_ec[slot] = sp
    valid_ec[slot] = 1.0
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    return (tok_ec[:-1].reshape(e, cap), w_ec[:-1].reshape(e, cap),
            valid_ec[:-1].reshape(e, cap), slot_of.reshape(n, k))


def combine(down, slot_of, top_e):
    """Each token's kept slots of ``down`` (E * C, d), in slot order
    (expert order), summed left to right in ``down``'s dtype; a dropped
    assignment reads the zero row past the buckets.  No scatter-add, so
    the order and the bits are the same on every run."""
    n, k = slot_of.shape
    by_expert = torch.argsort(top_e, dim=-1)                  # slot order
    slots = torch.gather(slot_of, 1, by_expert)
    rows = torch.cat([down, down.new_zeros((1, down.shape[1]))])[slots]
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def _moe_tokens(p: MoE, cfg, x):
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(n, d)

    logits = (xf @ p.router).to(torch.float32)                # (N, E)
    probs, top_p, top_e = route(logits, k)
    aux_loss = balance_loss(probs, top_e, e) * cfg.router_aux_weight

    cap = _capacity(n, cfg)
    tok_ec, w_ec, valid_ec, slot_of = dispatch(top_p, top_e, e, cap)

    xe = xf[tok_ec] * valid_ec[..., None].to(x.dtype)         # (E, C, d)
    gate = torch.bmm(xe, p.w_gate)
    up = torch.bmm(xe, p.w_up)
    down = torch.bmm(F.silu(gate) * up, p.w_down)
    down = down * (w_ec * valid_ec)[..., None].to(x.dtype)

    out = combine(down.reshape(e * cap, d), slot_of, top_e)
    dropped = 1.0 - torch.sum(valid_ec) / max(n * k, 1)
    return out.reshape(b, s, d).to(x.dtype), {
        "aux_loss": aux_loss, "drop_frac": dropped}
