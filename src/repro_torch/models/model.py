"""Model assembly, dense family: init / forward (prefill) / decode.

Counterpart of the reference package's ``models/model.py``.  The model is
an ``nn.Module`` with one :class:`Block` per layer in an ``nn.ModuleList``:
there is no period stacking, and the reference's ``tagged_scan`` over
layers is a Python loop.  The serving path only: no autograd, no remat.

The families the port does not run yet raise ``NotImplementedError``
naming their ROADMAP item, as do the sharding options (the port has no
mesh: the reference's ``constrain`` has no counterpart here).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig, layer_kinds

_FAMILY_ITEMS = {
    "moe": "Queue 1 item 11 (MoE)",
    "hybrid": "Queue 1 item 11 (RG-LRU hybrid)",
    "ssm": "Queue 1 item 11 (xLSTM)",
    "vlm": "Queue 1 item 11 (M-RoPE / vlm)",
    "audio": "Queue 1 item 11 (audio encoder)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for what the
    port does not run yet."""
    if cfg.family in _FAMILY_ITEMS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP {_FAMILY_ITEMS[cfg.family]})")
    if cfg.seq_parallel:
        raise NotImplementedError(
            f"{cfg.name}: seq_parallel is not ported yet (ROADMAP Queue 1 "
            "item 13, distributed)")
    if cfg.moe_impl != "gather":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl={cfg.moe_impl!r} is not ported yet "
            "(ROADMAP Queue 1 item 13, distributed)")


def period_pattern(cfg: ModelConfig) -> list[str]:
    check_ported(cfg)
    pat = ["attn"]
    assert layer_kinds(cfg)[:len(pat)] == pat
    return pat


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Block(nn.Module):
    """Pre-norm residual block: ``norm1``, ``attn``, ``norm2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = L.param((cfg.d_model,), dtype, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.norm2 = L.param((cfg.d_model,), dtype, device)
        if cfg.d_ff > 0:
            self.ffn = L.FFN(cfg, dtype, device)


class Model(nn.Module):
    """``embed`` (V, d), ``out_norm`` (d,), ``lm_head`` (d, V) unless the
    embeddings are tied, and ``blocks``.  Parameters are allocated, not
    initialised: :func:`init_model` draws them, and
    :func:`repro_torch.interop.model_params_from_numpy` loads them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        dev = resolve_device(device)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.embed = L.param((cfg.vocab, cfg.d_model), dt, dev)
        self.out_norm = L.param((cfg.d_model,), dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = L.param((cfg.d_model, cfg.vocab), dt, dev)
        self.blocks = nn.ModuleList(Block(cfg, dt, dev)
                                    for _ in range(cfg.n_layers))

    def w_out(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None) -> Model:
    """A :class:`Model` drawn as the reference draws it: every matrix
    normal x fan_in^-0.5 (fan_in its first axis), ``embed`` normal x 1.0,
    the norms ones; drawn in f32 and cast to ``cfg.dtype``.  The draws come
    from ``generator``, which lives on the model's device (the card unless
    ``device="cpu"``).  Its numbers are not JAX's: tests that compare the
    two packages carry JAX's weights over with ``interop``."""
    model = Model(cfg, device)
    dev = model.embed.device
    if generator.device.type != dev.type:
        raise ValueError(f"init_model: the generator lives on "
                         f"{generator.device}, the model on {dev}")
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if "norm" in leaf:
            p.fill_(1.0)
            continue
        scale = 1.0 if leaf == "embed" else p.shape[0] ** -0.5
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        p.copy_(w.mul_(scale))
    return model


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _run_block(cfg: ModelConfig, p: Block, x, positions, *,
               use_flash: bool = True):
    """Pre-norm residual block."""
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    x = x + L.run_attention(p.attn, cfg, h, positions, use_flash=use_flash)
    if cfg.d_ff > 0:
        x = x + L.run_ffn(p.ffn, L.rms_norm(x, p.norm2, cfg.norm_eps))
    return x


@torch.no_grad()
def forward(model: Model, tokens: torch.Tensor, *, use_flash: bool = True):
    """tokens (B, S) -> (logits (B, S, V), aux dict).  ``aux`` is empty for
    the dense family.  With ``use_flash`` (the default) every layer's
    attention is one flash_attention call; without it the reference's
    split between full scores and the chunked path."""
    cfg = model.cfg
    x = model.embed[tokens]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for blk in model.blocks:
        x = _run_block(cfg, blk, x, positions, use_flash=use_flash)
    x = L.rms_norm(x, model.out_norm, cfg.norm_eps)
    return x @ model.w_out(), {}


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> list[dict]:
    """One ``{"k", "v"}`` ring buffer of (batch, max_seq, Hk, Dh) per
    layer, zeros in ``cfg.dtype``, on the card unless ``device="cpu"``."""
    period_pattern(cfg)
    dev = resolve_device(device)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
             "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev)}
            for _ in range(cfg.n_layers)]


def _decode_block(cfg: ModelConfig, p: Block, cache: dict, x, pos):
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    out, ck, cv = L.run_attention_decode(p.attn, cfg, h, cache["k"],
                                         cache["v"], pos)
    cache = {"k": ck, "v": cv}
    x = x + out
    if cfg.d_ff > 0:
        x = x + L.run_ffn(p.ffn, L.rms_norm(x, p.norm2, cfg.norm_eps))
    return x, cache


@torch.no_grad()
def decode_step(model: Model, state: list[dict], token: torch.Tensor, pos):
    """One token for the whole stack.  token (B, 1) int; pos is (B,)
    per-sequence positions or a scalar (synchronized batch decode).
    Returns (logits (B, V), state): the caches are updated in place and
    returned."""
    cfg = model.cfg
    x = model.embed[token]
    pos = torch.as_tensor(pos, device=x.device)   # one copy, not one a layer
    new_state = []
    for blk, cache in zip(model.blocks, state):
        x, cache = _decode_block(cfg, blk, cache, x, pos)
        new_state.append(cache)
    x = L.rms_norm(x, model.out_norm, cfg.norm_eps)
    return (x @ model.w_out())[:, 0], new_state
