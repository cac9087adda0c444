"""LM layers: counterparts of the reference package's
``models/layers.py``.

The functions keep the reference's layouts (``x @ w`` with w of shape
(in, out); activations (B, S, H, Dh)) and its casts, so that the CPU
tests compare like with like.  The parameter containers are
``nn.Module``s (:class:`Attention`, :class:`FFN`) in place of the
reference's ``ParamStore`` subtrees, with the same parameter names and
shapes.  Their parameters are made without a gradient, so that serving
records no autograd graph; the trainer turns gradients on with
``model.requires_grad_(True)``, and the flash kernel's backward
(``flash_attention_bwd``) then takes the attention layers' gradient.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.registry import dispatch
from ..launch.scan_registry import tag_scope

NEG_INF = -1e30

# How :func:`repro_torch.models.model.init_model` draws a leaf: each
# module's ``INIT`` maps its own parameters to (init, scale), as the
# reference's ``ParamStore.add`` calls give them.  A normal draw's scale
# None is fan_in^-0.5, fan_in the first axis.
NORMAL = ("normal", None)
ONES = ("ones", None)
ZEROS = ("zeros", None)
# Each module's ``AXES`` maps its parameters to their logical axis names,
# as the reference's ``ParamStore.add`` calls name them; ``param_axes`` in
# ``models/model.py`` gathers them for ``param_sharding``.
REPLICATED = (None,)
IN_OUT = ("fsdp", "tensor")      # (d, out): input dim over fsdp
OUT_IN = ("tensor", "fsdp")      # (in, d)


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter that takes no gradient until the trainer
    asks for one."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """``wq`` (d, H Dh), ``wk``/``wv`` (d, Hk Dh), ``wo`` (H Dh, d), and
    with qk_norm ``q_norm``/``k_norm`` (Dh,)."""

    INIT = {"wq": NORMAL, "wk": NORMAL, "wv": NORMAL, "wo": NORMAL,
            "q_norm": ONES, "k_norm": ONES}
    AXES = {"wq": IN_OUT, "wk": IN_OUT, "wv": IN_OUT, "wo": OUT_IN,
            "q_norm": REPLICATED, "k_norm": REPLICATED}

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = param((d, h * dh), dtype, device)
        self.wk = param((d, hk * dh), dtype, device)
        self.wv = param((d, hk * dh), dtype, device)
        self.wo = param((h * dh, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = param((dh,), dtype, device)
            self.k_norm = param((dh,), dtype, device)


class FFN(nn.Module):
    """SwiGLU weights ``w_gate``/``w_up`` (d, d_ff), ``w_down`` (d_ff, d)."""

    INIT = {"w_gate": NORMAL, "w_up": NORMAL, "w_down": NORMAL}
    AXES = {"w_gate": IN_OUT, "w_up": IN_OUT, "w_down": OUT_IN}

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = param((d, f), dtype, device)
        self.w_up = param((d, f), dtype, device)
        self.w_down = param((f, d), dtype, device)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-6):
    """Variance in f32, data path in the input dtype."""
    var = torch.mean(torch.square(x.to(torch.float32)), -1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * gamma


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None):
    half = d_head // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x, angles):
    """x (..., S, H, Dh) rotated by angles (..., S, Dh/2), in f32."""
    cos = torch.cos(angles)[..., None, :]                    # (...,S,1,Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta=10_000.0):
    """x (..., S, H, Dh), positions (..., S) -> rotated x."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (Dh/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x, positions_thw, sections, theta=10_000.0):
    """Qwen2-VL M-RoPE: positions_thw (3, ..., S) give separate temporal /
    height / width indices; the frequency bands are split by ``sections``
    (summing to Dh/2) and each band rotates by its own component.  Band
    j is the number of section ends at or below j, at most 2."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (Dh/2,)
    j = torch.arange(x.shape[-1] // 2, device=x.device)
    band = sum(j >= end for end in itertools.accumulate(sections))
    band = band.clamp(max=2)                                 # (Dh/2,) {0,1,2}
    pos = torch.movedim(positions_thw.to(torch.float32)[band], 0, -1)
    return _rotate(x, pos * freqs)                           # pos (...,S,Dh/2)


# ---------------------------------------------------------------------------
# Attention (prefill: full or windowed; GQA by construction)
# ---------------------------------------------------------------------------

def _mask_value(device):
    return torch.tensor(NEG_INF, dtype=torch.float32, device=device)


def attention_scores(q, k, v, *, causal: bool, window: int | None = None,
                     use_flash: bool = False):
    """q (B,S,H,Dh), k/v (B,S,Hk,Dh) -> (B,S,H,Dh).

    ``window``: local (sliding) attention half-width in tokens.
    ``use_flash``: route through the kernel registry ("flash_attention":
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors).
    The (B, H, S, Dh) views passed to it are transposes, not copies: the
    kernel reads them through their strides."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    if use_flash and window is None:
        out = dispatch("flash_attention", q.transpose(1, 2),
                       k.transpose(1, 2), v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    group = h // hk
    qg = q.reshape(b, s, hk, group, dh).to(torch.float32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k.to(torch.float32)) / (dh ** 0.5)
    idx = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window is not None:
        mask &= idx[:, None] - idx[None, :] < window
    logits = torch.where(mask, logits, _mask_value(q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(torch.float32))
    return out.reshape(b, s, h, dh).to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool, window: int | None = None,
                      chunk_q: int = 1024, chunk_k: int = 1024):
    """Flash-style chunked attention in plain PyTorch: a loop over query
    chunks (outer) and KV chunks (inner) with online-softmax running
    stats, so the (S, S) score matrix never materialises.  The reference's
    casts: q is pre-scaled in its own dtype, the scores accumulate in f32,
    and p is cast to v's dtype before the PV product.  Causal KV chunks
    wholly after the query chunk are skipped: there every score is masked,
    so they would leave m, l and acc exactly as they are."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    group = h // hk
    cq = min(chunk_q, s)
    ck = min(chunk_k, s)
    if s % cq or s % ck:
        raise ValueError(f"attention_chunked: S = {s} is not a multiple of "
                         f"the chunks ({cq}, {ck})")
    nq, nk = s // cq, s // ck
    scale = torch.tensor(dh ** -0.5, dtype=q.dtype, device=q.device)
    rows = torch.arange(cq, device=q.device)
    cols = torch.arange(ck, device=q.device)
    neg = _mask_value(q.device)
    outs = []
    # one scope for both loops: the reference's two tagged scans, with
    # every op of the pair attributed to the inner one
    with tag_scope("tagscan_attn_q", nq), tag_scope("tagscan_attn_kv", nk):
        for qi in range(nq):
            qc = q[:, qi * cq:(qi + 1) * cq].reshape(b, cq, hk, group, dh)
            qcs = (qc * scale).to(torch.float32)
            m = torch.full((b, hk, group, cq), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros((b, hk, group, cq), dtype=torch.float32,
                            device=q.device)
            acc = torch.zeros((b, hk, group, cq, dh), dtype=torch.float32,
                              device=q.device)
            for ki in range(nk):
                if causal and ki * ck > qi * cq + cq - 1:
                    break
                kc = k[:, ki * ck:(ki + 1) * ck]
                vc = v[:, ki * ck:(ki + 1) * ck]
                logits = torch.einsum("bqhgd,bkhd->bhgqk", qcs,
                                      kc.to(torch.float32))
                grow = qi * cq + rows                  # global q positions
                gcol = ki * ck + cols
                mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
                if causal:
                    mask &= grow[:, None] >= gcol[None, :]
                if window is not None:
                    mask &= grow[:, None] - gcol[None, :] < window
                logits = torch.where(mask, logits, neg)
                m_cur = torch.amax(logits, -1)
                m_new = torch.maximum(m, m_cur)
                p = torch.exp(logits - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + torch.sum(p, -1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgqk,bkhd->bhgqd", p.to(vc.dtype).to(torch.float32),
                    vc.to(torch.float32))
                m = m_new
            out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,Hk,G,cq,D)
            out = torch.movedim(out, 3, 1).reshape(b, cq, h, dh)
            outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def _project_qkv(p: Attention, cfg, x, positions, mrope_positions=None):
    """q, k, v (B, S, H or Hk, Dh), rotated by M-RoPE when ``cfg.mrope``
    and ``mrope_positions`` (3, B, S) are given, else by plain RoPE."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p.wq).reshape(b, s, h, dh)
    k = (x @ p.wk).reshape(b, s, hk, dh)
    v = (x @ p.wv).reshape(b, s, hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def run_attention(p: Attention, cfg, x, positions, *, window=None,
                  use_flash: bool = True, mrope_positions=None,
                  chunked_threshold: int = 2048):
    """Full-sequence attention (prefill).  With ``use_flash`` and no
    window, the flash_attention kernel takes every S: it never builds the
    (S, S) scores.  Otherwise the reference's split: sequences longer than
    ``chunked_threshold`` go through :func:`attention_chunked`, shorter
    ones through :func:`attention_scores`."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, mrope_positions)
    if use_flash and window is None:
        out = attention_scores(q, k, v, causal=cfg.causal, use_flash=True)
    elif s > chunked_threshold:
        out = attention_chunked(q, k, v, causal=cfg.causal, window=window)
    else:
        out = attention_scores(q, k, v, causal=cfg.causal, window=window)
    return out.reshape(b, s, cfg.n_heads * cfg.d_head) @ p.wo


def run_attention_decode(p: Attention, cfg, x, cache_k, cache_v, pos, *,
                         window=None, mrope_positions=None):
    """One decode step.  x (B,1,d); cache_k/v (B,S,Hk,Dh) ring buffers,
    written IN PLACE (the reference returns new arrays; the port saves the
    copy) and returned; ``pos`` is either (B,) per-sequence positions or a
    scalar (int or 0-d tensor: synchronized batch decode)."""
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = cache_k.shape[1]
    pos_t = torch.as_tensor(pos, device=x.device).long()
    uniform = pos_t.dim() == 0
    pos_vec = pos_t.expand(b) if uniform else pos_t
    q, k, v = _project_qkv(p, cfg, x, pos_vec[:, None], mrope_positions)
    if uniform:
        slot = torch.remainder(pos_t, s).reshape(1)
        cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    else:
        rows = torch.arange(b, device=x.device)
        slots = torch.remainder(pos_vec, s)
        cache_k[rows, slots] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slots] = v[:, 0].to(cache_v.dtype)
    # Ring-buffer-aware validity: slot j holds absolute position
    # pos - ((pos - j) mod S) (negative -> never written).  For the
    # full-cache case (S > pos) this reduces to j <= pos.  torch's integer
    # remainder is a floor modulo, as JAX's is.
    kpos = torch.arange(s, device=x.device)[None, :]        # (1,S)
    stored = pos_vec[:, None] - torch.remainder(pos_vec[:, None] - kpos, s)
    valid = stored >= 0
    if window is not None:
        valid &= stored > pos_vec[:, None] - window
    group = h // hk
    qg = q.reshape(b, hk, group, dh)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                          cache_k.to(torch.float32)) / (dh ** 0.5)
    logits = torch.where(valid[:, None, None], logits,
                         _mask_value(x.device))
    w = torch.softmax(logits, -1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, cache_v.to(torch.float32))
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return out @ p.wo, cache_k, cache_v


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def run_ffn(p: FFN, x):
    return swiglu(x, p.w_gate, p.w_up, p.w_down)


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask):
    """logits (B, S, V), labels (B, S) int, mask (B, S) -> the mean NLL
    over the masked positions: logsumexp in f32 less the gold logit,
    summed under the mask and divided by max(sum(mask), 1)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
