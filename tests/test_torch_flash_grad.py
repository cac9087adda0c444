"""The gradient of the port's flash_attention against the JAX package, on
the CPU.

``flash_attention`` runs through ``FlashAttentionFn`` when an input
requires a gradient; on CPU tensors its backward is the plain version
``flash_attention_bwd_ref`` (the CUDA kernel against it is in
``test_torch_cuda.py`` and ``chip_smoke.py``).  The same numpy draws go
to both packages.  Tolerances:

* the Function's (dq, dk, dv) against ``jax.grad`` of the reference's
  ``attention_scores(use_flash=False)`` and ``attention_chunked``, f32:
  within 1e-5 of each gradient's max |JAX| (relative to the largest
  entry, since the two libraries sum the same f32 products in other
  orders and entries near zero carry that rounding);
* ``flash_attention_bwd_ref`` against torch autograd of the plain
  forward ``attention_ref``, f32: the same 1e-5;
* bf16 inputs: the plain backward against its f32 self on the same
  bf16 values, within one bf16 step (2^-7 of the max), since both compute
  in f32 and round once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.core import trace_execution
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from strategies import Draw

REL = 1e-5
BF16_STEP = 2.0 ** -7

# (B, Hq, Hk, S, D, causal): GQA, ragged S, D 16 and 64
SHAPES = [(2, 4, 2, 48, 16, True), (2, 4, 2, 48, 16, False),
          (1, 4, 4, 64, 64, True), (1, 8, 2, 37, 64, True),
          (2, 2, 1, 37, 16, False)]


def _draw(seed, b, hq, hk, s, d):
    draw = Draw(seed)
    return (draw.normal((b, s, hq, d)), draw.normal((b, s, hk, d)),
            draw.normal((b, s, hk, d)), draw.normal((b, s, hq, d)))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


def _port_grads(q, k, v, dout, causal):
    """(B, S, H, D) numpy -> the Function's grads, (B, S, H, D) numpy."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa_ops.flash_attention(*(t.transpose(1, 2) for t in ts),
                                 causal=causal).transpose(1, 2)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(dout))
    return [g.numpy() for g in grads]


def _jax_grads(fn, q, k, v, dout):
    def f(q, k, v):
        return jnp.sum(fn(q, k, v) * dout)
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))


@pytest.mark.parametrize("b,hq,hk,s,d,causal", SHAPES)
def test_function_grads_match_jax_scores(b, hq, hk, s, d, causal):
    q, k, v, dout = _draw(s * d + hq, b, hq, hk, s, d)
    got = _port_grads(q, k, v, dout, causal)
    want = _jax_grads(lambda q, k, v: JL.attention_scores(
        q, k, v, causal=causal, use_flash=False), q, k, v, dout)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("b,hq,hk,s,d,causal", SHAPES)
def test_function_grads_match_jax_chunked(b, hq, hk, s, d, causal):
    q, k, v, dout = _draw(s * d + hq + 1, b, hq, hk, s, d)
    chunk = 16 if s % 16 == 0 else s
    got = _port_grads(q, k, v, dout, causal)
    want = _jax_grads(lambda q, k, v: JL.attention_chunked(
        q, k, v, causal=causal, chunk_q=chunk, chunk_k=chunk), q, k, v, dout)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("b,hq,hk,s,d,causal", SHAPES)
def test_bwd_ref_matches_autograd_of_attention_ref(b, hq, hk, s, d, causal):
    q, k, v, dout = (torch.from_numpy(a).transpose(1, 2).contiguous()
                     for a in _draw(s + d, b, hq, hk, s, d))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ref.flash_attention_ref(*qkv, causal=causal)
    want = torch.autograd.grad(out, qkv, dout)
    got = fa_ref.flash_attention_bwd_ref(q, k, v, out.detach(), dout,
                                         causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        _close(g.numpy(), w.numpy())


def test_bwd_ref_bf16_within_one_step_of_f32():
    b, hq, hk, s, d = 2, 4, 2, 40, 16
    q, k, v, dout = (torch.from_numpy(a).transpose(1, 2).to(torch.bfloat16)
                     for a in _draw(7, b, hq, hk, s, d))
    out = fa_ref.flash_attention_ref(q, k, v)
    got = fa_ref.flash_attention_bwd_ref(q, k, v, out, dout)
    want = fa_ref.flash_attention_bwd_ref(
        *(t.float() for t in (q, k, v, out, dout)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), w.numpy(), BF16_STEP)


def test_function_routes_backward_through_registry():
    """The backward dispatches ``flash_attention_bwd`` (ref on the CPU),
    records it in the trace, and counts no kernel launch."""
    q, k, v, dout = (torch.from_numpy(a).transpose(1, 2)
                     for a in _draw(3, 1, 4, 2, 24, 16))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa_ops.flash_attention_bwd_launches
    with trace_execution() as tr:
        out = fa_ops.flash_attention(*qkv)
        torch.autograd.grad(out, qkv, dout)
    assert [(e.detail["name"], e.engine) for e in tr.kernels] == [
        ("flash_attention_bwd", "ref")]
    assert fa_ops.flash_attention_bwd_launches == before
    assert registry.get("flash_attention_bwd").resolve("auto", q) == "ref"
    with pytest.raises(ValueError):
        registry.dispatch("flash_attention_bwd", q, k, v, out.detach(), dout,
                          impl="cuda")


def test_no_grad_inputs_save_nothing():
    """Without an input that requires a gradient the forward is the plain
    serving call: no graph, the same bits as the plain version."""
    q, k, v, _ = (torch.from_numpy(a).transpose(1, 2)
                  for a in _draw(5, 1, 2, 1, 20, 16))
    out = fa_ops.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, fa_ref.flash_attention_ref(q, k, v))
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert fa_ops.flash_attention(qg, k, v).grad_fn is None
    assert isinstance(fa_ops.flash_attention(qg, k, v).grad_fn,
                      fa_ops.FlashAttentionFn._backward_cls)


def test_bwd_wrapper_checks_inputs():
    q, k, v, dout = (torch.from_numpy(a).transpose(1, 2)
                     for a in _draw(9, 1, 2, 1, 16, 16))
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, k, v, q[:, :, :8], dout)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, k, v, q, dout.to(torch.bfloat16))
