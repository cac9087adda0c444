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
  in f32 and round once;
* the forward's log-sum-exp (``return_lse=True``) against
  ``jax.nn.logsumexp`` of the reference's scaled, masked f32 logits: within
  1e-5 of max(1, |lse|) per row (the same f32 products summed in other
  orders).
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
    _, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, k, v, q[:, :, :8], dout, lse)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, k, v, q, dout.to(torch.bfloat16), lse)


def _lse_cases(q, lse):
    """lse arguments the backward must refuse: wrong shape, dtype,
    layout, or not a tensor."""
    return [lse[:, :, :-1], lse.to(torch.bfloat16), lse.double(),
            lse.transpose(0, 1), lse.mT.contiguous().mT, lse.unsqueeze(-1),
            lse.numpy()]


def test_bwd_wrapper_checks_lse():
    """The backward takes the forward's lse, f32 (B, Hq, S), contiguous,
    on q's device; anything else raises before any work, and so does a
    call without it."""
    q, k, v, dout = (torch.from_numpy(a).transpose(1, 2)
                     for a in _draw(10, 2, 2, 1, 16, 16))
    out, lse = fa_ops.flash_attention(q, k, v, return_lse=True)
    for bad in _lse_cases(q, lse):
        with pytest.raises(ValueError, match="lse"):
            fa_ops.flash_attention_bwd(q, k, v, out, dout, bad)
    with pytest.raises(TypeError):
        fa_ops.flash_attention_bwd(q, k, v, out, dout)
    got = fa_ops.flash_attention_bwd(q, k, v, out, dout, lse)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _jax_lse(q, k, causal):
    """jax.nn.logsumexp of the reference's scaled, masked f32 logits
    (``attention_scores``' own), (B, S, H, D) numpy in, (B, Hq, S) out."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    qg = jnp.asarray(q).reshape(b, s, hk, h // hk, dh)
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k),
                        preferred_element_type=jnp.float32) / (dh ** 0.5)
    if causal:
        idx = jnp.arange(s)
        logits = jnp.where((idx[:, None] >= idx[None, :])[None, None, None],
                           logits, -1e30)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(b, h, s)


@pytest.mark.parametrize("b,hq,hk,s,d,causal", SHAPES)
def test_ref_lse_matches_jax_logsumexp(b, hq, hk, s, d, causal):
    q, k, v, _ = _draw(s * d + hq + 2, b, hq, hk, s, d)
    out, lse = fa_ref.flash_attention_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal, return_lse=True)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    want = _jax_lse(q, k, causal)
    err = np.abs(lse.numpy().astype(np.float64) - want)
    assert float((err / np.maximum(1.0, np.abs(want))).max()) <= REL
    # the output is the plain version's without lse, bit for bit
    assert torch.equal(out, fa_ref.flash_attention_ref(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_forward_return_lse(causal):
    """``flash_attention(..., return_lse=True)`` gives the plain version's
    output bits and its log-sum-exp; it refuses inputs that want a
    gradient, since that call records no graph."""
    q, k, v, _ = (torch.from_numpy(a).transpose(1, 2)
                  for a in _draw(11, 2, 4, 2, 24, 16))
    out, lse = fa_ops.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
    want_out, want_lse = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                                    return_lse=True)
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, causal=causal))
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="return_lse"):
        fa_ops.flash_attention(qg, k, v, causal=causal, return_lse=True)
    with torch.no_grad():
        out_ng, _ = fa_ops.flash_attention(qg, k, v, causal=causal,
                                           return_lse=True)
    assert torch.equal(out_ng, out)


@pytest.mark.parametrize("b,hq,hk,s,d,causal", SHAPES)
def test_function_saves_and_passes_lse(monkeypatch, b, hq, hk, s, d, causal):
    """FlashAttentionFn saves the forward's lse and hands it to the
    backward's dispatch as its sixth argument; the gradients are the plain
    backward's."""
    q, k, v, dout = (torch.from_numpy(a).transpose(1, 2)
                     for a in _draw(s + hq + 3, b, hq, hk, s, d))
    seen = []
    entry = registry.get("flash_attention_bwd")

    def ref(*args, **kwargs):
        seen.append(args)
        return entry.ref(*args, **kwargs)

    monkeypatch.setitem(registry._REGISTRY, "flash_attention_bwd",
                        registry.KernelEntry("flash_attention_bwd", ref,
                                             entry.cuda))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*qkv, causal=causal)
    saved = out.grad_fn.saved_tensors
    grads = torch.autograd.grad(out, qkv, dout)
    want_lse = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                          return_lse=True)[1]
    assert len(saved) == 5 and torch.equal(saved[4], want_lse)
    assert len(seen) == 1 and len(seen[0]) == 6
    assert torch.equal(seen[0][5], want_lse)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out.detach(), dout,
                                          causal=causal)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def _bf16(shape, offset=0):
    """A bf16 tensor of ``shape`` whose data starts ``offset`` elements
    into a fresh buffer (offset 1 breaks TMA's 16-byte rule)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("case,want", [
    ("bf16", "tc"), ("f32", "ffma"), ("bf16 D=12", "ffma"),
    ("bf16 dout off 16 bytes", "ffma"), ("bf16 lse off 16 bytes", "ffma"),
    ("bf16 (B, S, H, D) storage", "tc"),
    ("bf16 out head stride 4", "ffma")])
def test_bwd_kernel_choice_on_metadata(case, want):
    """The backward's tc/ffma choice reads only dtype, D, pointers and
    strides (the forward's rule, with dout and lse), so it is checked on
    CPU tensors."""
    b, hq, hk, s = 2, 4, 2, 40
    d = 12 if "D=12" in case else 16
    dt = torch.float32 if case == "f32" else torch.bfloat16
    q, out, dout = (torch.zeros((b, hq, s, d), dtype=dt) for _ in range(3))
    k, v = (torch.zeros((b, hk, s, d), dtype=dt) for _ in range(2))
    lse = torch.zeros((b, hq, s))
    if "dout off" in case:
        dout = _bf16((b, hq, s, d), 1)
    if "lse off" in case:
        lse = torch.zeros(b * hq * s + 1)[1:].view(b, hq, s)
    if "storage" in case:
        q, out, dout = (_bf16((b, s, hq, d)).transpose(1, 2)
                        for _ in range(3))
        k, v = (_bf16((b, s, hk, d)).transpose(1, 2) for _ in range(2))
    if "head stride" in case:
        out = torch.zeros(2 * b * hq * s * d, dtype=dt).as_strided(
            (b, hq, s, d), (hq * s * d, 4, d, 1))
    assert fa_ops.bwd_kernel_for(q, k, v, out, dout, lse) == want
