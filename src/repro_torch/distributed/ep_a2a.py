"""Sequence-sharded all-to-all expert parallelism (``moe_impl="a2a"``).

Counterpart of the reference package's ``distributed/ep_a2a.py``.  The
reference shards tokens over the expert axis at the MoE boundary, routes
each shard's tokens into per-shard capacity buckets, and moves only the
routed rows with two all-to-alls (dispatch and return) inside a
``shard_map`` over (batch axes..., expert axis).  On one controller the
mesh positions run in a loop:

* each (batch shard, sequence shard) routes its own tokens
  (:func:`_local_dispatch`) into E buckets of
  ``max(8, ceil(n_loc k cf / E / 8) 8)`` slots — the per-shard capacity,
  not the baseline's over all tokens;
* the dispatch all-to-all is a transposition of per-shard lists: expert
  shard j' takes, from every source shard j in order, the buckets of its
  E / EP experts, and runs them as one (E_loc, EP C, d) batch with f32
  accumulation (the reference's ``preferred_element_type``);
* the return all-to-all transposes back, and each source shard combines
  its tokens' kept slots in expert order, left to right (the baseline's
  ordered gather, ``models/moe.py`` ``combine``, never a scatter-add);
* ``aux_loss`` and ``drop_frac`` are means over the expert shards, then
  over the batch shards, summed in position order.

The reference's ``init_moe_a2a`` has the baseline MoE's parameter shapes
and is served by :class:`repro_torch.models.moe.MoE`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import moe as MOE
from .sharding import (Mesh, axes_in_mesh, axis_extent, check_mesh,
                       on_device, ordered_mean, split_range)


def _local_dispatch(xf, logits, e: int, k: int, cap: int):
    """One shard's routing and capacity bucketing (the baseline's
    algorithm).  Returns (tok (E, C), w (E, C), valid (E, C), aux, slot_of
    (N, k), top_e (N, k)): the reference's four, then what the ordered
    combine needs.  ``aux`` is ``E * sum(me * ce)`` before
    ``router_aux_weight``."""
    probs, top_p, top_e = MOE.route(logits, k)
    aux = MOE.balance_loss(probs, top_e, e)
    tok, w, valid, slot_of = MOE.dispatch(top_p, top_e, e, cap)
    return tok, w, valid, aux, slot_of, top_e


def _bmm_f32(a, b):
    """``a @ b`` batched, accumulated and returned in f32 (the
    reference's ``preferred_element_type=f32``).  The CPU has no
    ``out_dtype`` matmul: there the operands go up to f32 first."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def make_run_moe_a2a(mesh: Mesh, cfg, *, batch_axes=("pod", "data"),
                     expert_axis: str = "model", fsdp_axis: str = "data"):
    """Returns ``moe_fn(p, x) -> (out, {"aux_loss", "drop_frac"})`` for a
    :class:`~repro_torch.models.moe.MoE` ``p`` and x (B, S, d) split
    P(batch_axes, expert_axis, None): B over the batch axes that ``mesh``
    has, S over ``expert_axis``.  Raises where the reference's
    ``shard_map`` would: E, B, S or the experts' d that do not divide
    their axes."""
    check_mesh(mesh, "make_run_moe_a2a")
    batch_axes = axes_in_mesh(mesh, batch_axes)
    ep = mesh.shape[expert_axis]
    e, k = cfg.n_experts, cfg.top_k
    if e % ep:
        raise ValueError(f"make_run_moe_a2a: {e} experts on {ep} shards")
    e_loc = e // ep
    n_fsdp = axis_extent(mesh, axes_in_mesh(mesh, fsdp_axis))
    lead = mesh.segments(batch_axes + (expert_axis,))

    def moe_fn(p, x):
        b, s, d = x.shape
        if d % n_fsdp:
            raise ValueError(f"make_run_moe_a2a: d_model {d} on {n_fsdp} "
                             f"{fsdp_axis} shards")
        rows = split_range(b, axis_extent(mesh, batch_axes), "a2a batch")
        seqs = split_range(s, ep, "a2a sequence")
        outs, auxs, drops = [], [], []
        for bi, (b0, b1) in enumerate(rows):
            devs = lead[bi * ep:(bi + 1) * ep]
            # per source shard j: its tokens, routed into (E, C) buckets
            src = []
            for j, (s0, s1) in enumerate(seqs):
                xl = on_device(x[b0:b1, s0:s1], devs[j], position=(bi, j))
                n_loc = xl.shape[0] * xl.shape[1]
                xf = xl.reshape(n_loc, d)
                cap = MOE._capacity(n_loc, cfg)
                logits = (xf @ on_device(p.router, devs[j])).to(
                    torch.float32)
                tok, w, valid, aux, slot_of, top_e = _local_dispatch(
                    xf, logits, e, k, cap)
                xe = xf[tok] * valid[..., None].to(x.dtype)   # (E, C, d)
                src.append((xe, w, valid, aux, slot_of, top_e, n_loc, cap))
            cap = src[0][7]
            # dispatch all-to-all: expert shard j' takes its experts'
            # buckets from every source shard, in source order
            back = [[None] * ep for _ in range(ep)]
            for jp in range(ep):
                ex = slice(jp * e_loc, (jp + 1) * e_loc)
                recv = torch.stack([on_device(t[0][ex], devs[jp])
                                    for t in src], 1)   # (E_loc, EP, C, d)
                recv = recv.reshape(e_loc, ep * cap, d)
                wg, wu, wd = (on_device(w[ex], devs[jp])
                              for w in (p.w_gate, p.w_up, p.w_down))
                gate = _bmm_f32(recv, wg)
                up = _bmm_f32(recv, wu)
                hidden = (F.silu(gate) * up).to(x.dtype)
                out = _bmm_f32(hidden, wd).to(x.dtype)
                out = out.reshape(e_loc, ep, cap, d)
                # return all-to-all: source shard j gets slice [:, j]
                for j in range(ep):
                    back[j][jp] = on_device(out[:, j], devs[j])
            shard_out, shard_aux, shard_drop = [], [], []
            for j, (xe, w, valid, aux, slot_of, top_e, n_loc, _) in \
                    enumerate(src):
                bk = torch.cat(back[j], 0)                    # (E, C, d)
                bk = bk * (w * valid)[..., None].to(x.dtype)
                comb = MOE.combine(bk.reshape(e * cap, d), slot_of, top_e)
                shard_out.append(comb.reshape(b1 - b0, -1, d).to(x.dtype))
                shard_aux.append(aux)
                shard_drop.append(1.0 - torch.sum(valid) / max(n_loc * k, 1))
            outs.append(torch.cat([on_device(o, x.device)
                                   for o in shard_out], 1))
            auxs.append(ordered_mean([on_device(a, x.device)
                                      for a in shard_aux]))
            drops.append(ordered_mean([on_device(v, x.device)
                                       for v in shard_drop]))
        out = torch.cat(outs, 0)
        return out, {"aux_loss": ordered_mean(auxs) * cfg.router_aux_weight,
                     "drop_frac": ordered_mean(drops)}

    return moe_fn

