"""Split-K (sequence-sharded) decode attention: FlashDecoding over a mesh.

Counterpart of the reference package's ``distributed/decode.py``.  At
decode the KV cache dwarfs everything else, and kv-head counts (1 to 8)
are below a 16-way tensor axis, so the cache is split along its
sequence over the ``seq_axis``: each shard computes a partial attention
(max, sum of exponentials, weighted V) over its slice of keys, and the
shards combine with a log-sum-exp reduction.  The reference combines
with ``pmax`` and two ``psum``s inside a ``shard_map``; on one controller
the shards run in order, the max is exact in any order, and the two sums
are left folds in shard order.  Works for any kv-head count, MQA
(kv = 1) included.
"""

from __future__ import annotations

import torch

from ..models.layers import NEG_INF
from .sharding import (Mesh, axes_in_mesh, axis_extent, check_mesh,
                       on_device, split_range)


def splitk_partial(q, k_shard, v_shard, valid_shard):
    """One shard's partials, in f32.  q (B, Hk, G, Dh); k/v (B, Sl, Hk,
    Dh); valid (B, Sl).  Returns (m (B, Hk, G), l (B, Hk, G), acc (B, Hk,
    G, Dh))."""
    dh = q.shape[-1]
    logits = torch.einsum("bhgd,bkhd->bhgk", q.to(torch.float32),
                          k_shard.to(torch.float32)) / (dh ** 0.5)
    # -1e30, not -inf: a shard whose keys all lie past pos then carries
    # a zero correction, not NaN
    logits = torch.where(valid_shard[:, None, None, :], logits,
                         torch.tensor(NEG_INF, device=logits.device))
    m = torch.amax(logits, -1)
    p = torch.exp(logits - m[..., None])
    l = torch.sum(p, -1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_shard.to(torch.float32))
    return m, l, acc


def splitk_combine(ms: list, ls: list, accs: list):
    """The log-sum-exp combine of the shards' partials, given in shard
    order: the max over shards, then each shard's l and acc rescaled by
    exp(m - max) and summed left to right."""
    m_all = ms[0]
    for m in ms[1:]:
        m_all = torch.maximum(m_all, m)
    l_all = acc_all = None
    for m, l, acc in zip(ms, ls, accs):
        corr = torch.exp(m - m_all)
        lc, ac = l * corr, acc * corr[..., None]
        l_all = lc if l_all is None else l_all + lc
        acc_all = ac if acc_all is None else acc_all + ac
    return acc_all / torch.clamp(l_all, min=1e-30)[..., None]


def make_splitk_decode_attention(mesh: Mesh, *, seq_axis: str = "model",
                                 batch_axes=("pod", "data")):
    """Returns ``attn(q (B, 1, H, Dh), cache_k/v (B, S, Hk, Dh), pos (B,))``
    with the cache split P(batch_axes, seq_axis, None, None): B over
    ``batch_axes``, S over ``seq_axis`` (shard s holds keys [s Sl, (s + 1)
    Sl)).  Raises where the reference's ``shard_map`` would: an axis the
    mesh lacks, or B or S that do not divide."""
    check_mesh(mesh, "make_splitk_decode_attention")
    batch_axes = tuple(batch_axes)
    missing = [a for a in batch_axes + (seq_axis,)
               if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"make_splitk_decode_attention: axes {missing} "
                         f"not in {mesh.axis_names}")
    ns = mesh.shape[seq_axis]
    nb = axis_extent(mesh, axes_in_mesh(mesh, batch_axes))
    devs = mesh.segments(batch_axes + (seq_axis,))

    def attn(q, ck, cv, pos):
        b, _, h, dh = q.shape
        hk = ck.shape[2]
        rows = split_range(b, nb, "split-K batch")
        keys = split_range(ck.shape[1], ns, "split-K sequence")
        pos = torch.as_tensor(pos, device=q.device)
        outs = []
        for bi, (b0, b1) in enumerate(rows):
            qg = q[b0:b1].reshape(b1 - b0, hk, h // hk, dh)
            parts = ([], [], [])
            for s, (k0, k1) in enumerate(keys):
                dev = devs[bi * ns + s]
                kpos = torch.arange(k0, k1, device=dev)[None, :]
                valid = kpos <= on_device(pos[b0:b1], dev)[:, None]
                m, l, acc = splitk_partial(
                    on_device(qg, dev), on_device(ck[b0:b1, k0:k1], dev),
                    on_device(cv[b0:b1, k0:k1], dev), valid)
                for lst, t in zip(parts, (m, l, acc)):
                    lst.append(on_device(t, q.device))
            out = splitk_combine(*parts)
            outs.append(out.reshape(b1 - b0, 1, h, dh).to(q.dtype))
        return torch.cat(outs, 0)

    return attn
