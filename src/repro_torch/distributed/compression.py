"""Gradient compression: int8 stochastic rounding with error feedback.

Counterpart of the reference package's ``distributed/compression.py``.
Each tensor is quantized onto 255 levels of one per-tensor scale with
stochastic rounding (unbiased), and the residual is fed back into the
next round (EF-SGD), which keeps convergence:

    q = quantize(g + e);  merged = sum(q) / n;  e' = (g + e) - dequant(q)

JAX's key stream cannot be reproduced in torch, so each quantizer comes
in two halves: the uniforms are drawn from a ``torch.Generator``, or
given (``uniforms=``, the way the tests feed JAX's draws), and the
rounding takes them as they are.  :func:`compressed_psum` is the merge
over a mesh axis: the shards' gradients come as a list in shard order,
the scale is agreed first (the max over shards, exact in any order) so
every shard rounds onto one grid, and the int8 values are summed as
int32, exact in any order.  As in the reference, where one key is
replicated over the axis, every shard rounds with the same uniforms.
"""

from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_leaves, tree_map
from .sharding import on_device


def draw_uniforms(shape, generator: torch.Generator) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape`` on the generator's device."""
    return torch.rand(tuple(shape), generator=generator,
                      dtype=torch.float32, device=generator.device)


def _scale(x32):
    return torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0


# the reference's merge runs compiled, and XLA turns its division by the
# constant 127 into a product with the f32 reciprocal
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _merge_scale(x32):
    return torch.clamp(torch.max(torch.abs(x32)), min=1e-12) * \
        _INV_127.to(x32.device)


def _round(scaled, u):
    """Stochastic rounding of ``scaled`` with uniforms ``u``: up with
    probability ``scaled - floor(scaled)``, clipped to [-127, 127] (f32)."""
    low = torch.floor(scaled)
    up = (u < (scaled - low)).to(torch.float32)
    return torch.clamp(low + up, -127.0, 127.0)


def _residual(c, q, scale):
    """``c - q * scale`` rounded once to f32, as the reference's compiled
    merge computes it (a fused multiply-add): q (an integer of 7 bits)
    times a f32 scale is exact in f64, and so is its difference from c,
    which lies within one scale of it."""
    return (c.to(torch.float64) - q.to(torch.float64)
            * scale.to(torch.float64)).to(torch.float32)


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None,
                  *, uniforms: torch.Tensor | None = None):
    """Stochastic rounding to int8 with a per-tensor scale.  Returns (q
    int8, scale 0-d f32)."""
    x32 = x.to(torch.float32)
    u = uniforms if uniforms is not None else _draw(x.shape, generator)
    scale = _scale(x32)
    return _round(x32 / scale, u).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params) -> Any:
    """f32 zeros shaped like each leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _draw(shape, generator):
    if generator is None:
        raise ValueError("compression: pass a generator or uniforms=")
    return draw_uniforms(shape, generator)


def _uniform_leaves(grads, generator, uniforms) -> list:
    """One uniform tensor per leaf of ``grads``: ``uniforms``' leaves, or
    drawn from ``generator`` leaf by leaf in tree order."""
    if uniforms is not None:
        return tree_leaves(uniforms)
    return [_draw(g.shape, generator) for g in tree_leaves(grads)]


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def compress_grads(grads, error, generator: torch.Generator | None = None,
                   *, uniforms=None):
    """Returns (quantized tree, scales tree, new error feedback tree)."""
    us = _uniform_leaves(grads, generator, uniforms)
    qs, scales, new_e = [], [], []
    for g, e, u in zip(tree_leaves(grads), tree_leaves(error), us):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected, uniforms=u)
        qs.append(q)
        scales.append(s)
        new_e.append(corrected - dequantize_int8(q, s))
    return (_unflatten(grads, qs), _unflatten(grads, scales),
            _unflatten(grads, new_e))


def compressed_psum(grads: list, error: list,
                    generator: torch.Generator | None = None, *,
                    uniforms=None):
    """The int8-quantized mean over a mesh axis, with error feedback.

    ``grads`` and ``error`` hold one tree per shard along the axis, in
    shard order.  Per leaf: each shard's corrected gradient ``g + e``;
    the scale, the max over shards of max|g + e| / 127 (floored at
    1e-12 / 127); each shard's stochastic rounding onto that grid with the
    leaf's uniforms; the int32 sum of the int8 values times scale / n.
    Returns (the merged tree, on the first shard's device; the shards'
    new error trees).  Bytes merged: one int8 a value, a quarter of f32,
    plus one scale a leaf.  The scale's division by 127 is a product with
    its f32 reciprocal and the new error ``c - q scale`` is rounded once,
    as the reference's compiled merge computes them."""
    n = len(grads)
    us = _uniform_leaves(grads[0], generator, uniforms)
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in error]
    outs, new_es = [], [[] for _ in range(n)]
    for i, u in enumerate(us):
        dev = flat_g[0][i].device
        corrected = [flat_g[s][i].to(torch.float32) + flat_e[s][i]
                     for s in range(n)]
        scale = on_device(_merge_scale(corrected[0]), dev)
        for c in corrected[1:]:
            scale = torch.maximum(scale, on_device(_merge_scale(c), dev))
        summed = None
        for s, c in enumerate(corrected):
            sc = on_device(scale, c.device)
            q = _round(c / sc, on_device(u, c.device))
            q32 = on_device(q.to(torch.int32), dev)
            summed = q32 if summed is None else summed + q32
            new_es[s].append(_residual(c, q, sc))
        outs.append(summed.to(torch.float32) * scale / n)
    return (_unflatten(grads[0], outs),
            [_unflatten(grads[s], new_es[s]) for s in range(n)])
