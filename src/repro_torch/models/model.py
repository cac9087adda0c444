"""Model assembly, every family: init / forward (prefill) / decode.

Counterpart of the reference package's ``models/model.py``.  The model is
an ``nn.Module`` with one :class:`Block` per layer in an ``nn.ModuleList``,
each of its layer's kind (``layer_kinds``: attn for dense, moe, vlm and
audio; the (rglru, rglru, local) period for hybrid; (mlstm, slstm) for
ssm).  There is no period stacking: the reference's ``tagged_scan`` over
layers is a Python loop over the full periods inside ``tag_scope`` (the
same tag and trip count), and ``interop`` maps layer i to its period
slot.
:func:`forward` serves and trains: a model made by :func:`init_model`
takes no gradient and records no graph; once the trainer calls
``model.requires_grad_(True)``, each full period of blocks runs under
``torch.utils.checkpoint`` where ``cfg.remat`` (the reference's
``jax.checkpoint(period_body)``), and :func:`train_loss` is the loss.

Under :func:`~repro_torch.distributed.sharding.activation_sharding` the
blocks name their logical layouts through ``constrain`` as the
reference's do (``seq_parallel`` keeps the residual stream split over the
sequence and gathers it only for attention), which leaves every tensor
as it is: a forward under a mesh is bitwise the unsharded one.  The one
block that changes its algorithm under a mesh is the MoE with
``moe_impl="a2a"``, which routes each sequence shard on its own
(``distributed/ep_a2a.py``).  :func:`param_axes` and
:func:`decode_state_axes` name the logical axes of the parameters and of
the decode state, for ``param_sharding``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.sharding import constrain, get_active
from ..launch.scan_registry import tagged
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import xlstm as XL
from .config import ModelConfig, layer_kinds


def period_pattern(cfg: ModelConfig) -> list[str]:
    """The family's repeating block pattern: the reference stacks the
    parameters of pattern position p of every full period together."""
    if cfg.family == "hybrid":
        pat = list(cfg.block_pattern or ("rglru", "rglru", "local"))
    elif cfg.family == "ssm":
        pat = ["mlstm"] * (cfg.slstm_every - 1) + ["slstm"]
    else:
        pat = ["attn"]
    assert layer_kinds(cfg)[:len(pat)] == pat
    return pat


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Block(nn.Module):
    """Pre-norm residual block of one kind: ``norm1`` and then
    ``attn``, ``norm2`` and ``moe`` or ``ffn`` (attn, local);
    ``rglru`` and, with a d_ff, ``norm2`` and ``ffn`` (rglru); ``mlstm``;
    ``slstm``."""

    INIT = {"norm1": L.ONES, "norm2": L.ONES}
    AXES = {"norm1": L.REPLICATED, "norm2": L.REPLICATED}

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = L.param((cfg.d_model,), dtype, device)
        if kind in ("attn", "local"):
            self.attn = L.Attention(cfg, dtype, device)
            self.norm2 = L.param((cfg.d_model,), dtype, device)
            if cfg.is_moe:
                self.moe = MOE.MoE(cfg, dtype, device)
            elif cfg.d_ff > 0:
                self.ffn = L.FFN(cfg, dtype, device)
        elif kind == "rglru":
            self.rglru = RG.RGLRU(cfg, dtype, device)
            if cfg.d_ff > 0:
                self.norm2 = L.param((cfg.d_model,), dtype, device)
                self.ffn = L.FFN(cfg, dtype, device)
        elif kind == "mlstm":
            self.mlstm = XL.MLSTM(cfg, dtype, device)
        elif kind == "slstm":
            self.slstm = XL.SLSTM(cfg, dtype, device)
        else:
            raise ValueError(kind)


class Model(nn.Module):
    """``embed`` (V, d), ``out_norm`` (d,), ``lm_head`` (d, V) unless the
    embeddings are tied, and ``blocks``.  Parameters are allocated, not
    initialised: :func:`init_model` draws them, and
    :func:`repro_torch.interop.model_params_from_numpy` loads them."""

    INIT = {"embed": ("normal", 1.0), "out_norm": L.ONES,
            "lm_head": L.NORMAL}
    AXES = {"embed": ("vocab", "fsdp"), "out_norm": L.REPLICATED,
            "lm_head": ("fsdp", "vocab")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.embed = L.param((cfg.vocab, cfg.d_model), dt, dev)
        self.out_norm = L.param((cfg.d_model,), dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = L.param((cfg.d_model, cfg.vocab), dt, dev)
        self.blocks = nn.ModuleList(Block(cfg, kind, dt, dev)
                                    for kind in layer_kinds(cfg))

    def w_out(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None) -> Model:
    """A :class:`Model` drawn leaf by leaf as the reference's
    ``ParamStore.add`` calls draw it: each module's ``INIT`` table gives
    a leaf's (init, scale); a normal draw without a scale is scaled by
    fan_in^-0.5, fan_in the leaf's first axis (E for the experts); drawn
    in f32 and cast to ``cfg.dtype``.  The draws come from ``generator``,
    which lives on the model's device (the card unless ``device="cpu"``).
    Its numbers are not JAX's: tests that compare the two packages carry
    JAX's weights over with ``interop``."""
    model = Model(cfg, device)
    dev = model.embed.device
    if generator.device.type != dev.type:
        raise ValueError(f"init_model: the generator lives on "
                         f"{generator.device}, the model on {dev}")
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            init, scale = module.INIT[name]
            if init != "normal":
                p.fill_(1.0 if init == "ones" else 0.0)
                continue
            if scale is None:
                scale = (p.shape[0] if p.dim() > 1
                         else max(p.shape[0], 1)) ** -0.5
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=dev)
            p.copy_(w.mul_(scale))
    return model


def param_axes(model: Model) -> dict[str, tuple]:
    """The logical axes of each parameter, keyed by its name in
    ``model.named_parameters()`` (the reference's ``init_model`` axes
    tree, each layer's without the period stack's leading "layers")."""
    out = {}
    for prefix, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            out[f"{prefix}.{name}" if prefix else name] = module.AXES[name]
    return out


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _moe_dispatch(cfg: ModelConfig, p, h2):
    """The baseline gather MoE, or with ``moe_impl="a2a"`` under an active
    mesh the sequence-sharded all-to-all MoE."""
    if cfg.moe_impl == "a2a":
        active = get_active()
        if active is not None:
            from ..distributed.ep_a2a import make_run_moe_a2a
            mesh, rules = active
            batch = rules.get("batch", ("pod", "data"))
            batch = batch if isinstance(batch, tuple) else (batch,)
            h2s = constrain(h2, ("batch", "tensor", None))
            moe_fn = make_run_moe_a2a(
                mesh, cfg, batch_axes=batch,
                expert_axis=rules.get("expert", "model"),
                fsdp_axis=rules.get("fsdp", "data"))
            out, aux = moe_fn(p, h2s)
            return constrain(out, ("batch", None, None)), aux
    return MOE.run_moe(p, cfg, h2)


def _layout(cfg: ModelConfig) -> tuple:
    """The residual stream's logical layout: split over the sequence on
    the tensor axis under ``seq_parallel`` (Megatron-SP), else only over
    the batch."""
    return (("batch", "tensor", None) if cfg.seq_parallel
            else ("batch", None, None))


def _run_block(cfg: ModelConfig, p: Block, x, positions, *,
               mrope_positions=None, aux_acc=None, use_flash: bool = True):
    """Pre-norm residual block; returns (x, aux_acc)."""
    kind = p.kind
    layout = _layout(cfg)
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    if kind in ("attn", "local"):
        window = cfg.local_window if kind == "local" else None
        if cfg.seq_parallel:
            # gather the sequence only for attention; scatter right after
            h = constrain(h, ("batch", None, None))
        attn_out = L.run_attention(p.attn, cfg, h, positions, window=window,
                                   use_flash=use_flash,
                                   mrope_positions=mrope_positions)
        x = constrain(x + constrain(attn_out, layout), layout)
        h2 = L.rms_norm(x, p.norm2, cfg.norm_eps)
        if cfg.is_moe:
            out, aux = _moe_dispatch(cfg, p.moe, h2)
            x = x + constrain(out, layout)
            if aux_acc is not None:
                aux_acc = {k: aux_acc[k] + aux[k] for k in aux_acc}
        elif cfg.d_ff > 0:
            x = x + L.run_ffn(p.ffn, h2)
    elif kind == "rglru":
        out, _ = RG.run_rglru(p.rglru, cfg, h)
        x = x + out
        if cfg.d_ff > 0:
            x = x + L.run_ffn(p.ffn, L.rms_norm(x, p.norm2, cfg.norm_eps))
    elif kind == "mlstm":
        x = x + XL.run_mlstm(p.mlstm, cfg, h)
    else:
        out, _ = XL.run_slstm(p.slstm, cfg, h)
        x = x + out
    return constrain(x, layout), aux_acc


def _run_period(cfg: ModelConfig, blocks, x, positions, mrope_positions,
                aux, use_flash: bool):
    """One full period of the block pattern (remat's unit)."""
    for blk in blocks:
        x, aux = _run_block(cfg, blk, x, positions,
                            mrope_positions=mrope_positions, aux_acc=aux,
                            use_flash=use_flash)
    return x, aux


def forward(model: Model, tokens=None, *, embeddings=None,
            mrope_positions=None, collect_aux: bool = True,
            use_flash: bool = True):
    """tokens (B, S) -> (logits (B, S, V), aux dict).

    ``embeddings`` (B, S_e, d) (stub frame or patch embeddings) are cast
    to the model's dtype and come first; token embeddings follow them.
    ``mrope_positions`` (3, B, S) rotate attention by M-RoPE where
    ``cfg.mrope``.  ``aux`` holds ``aux_loss`` and ``drop_frac`` summed
    over the layers for MoE, and is empty otherwise; ``collect_aux`` is
    the reference's argument and, as there, changes nothing.  With
    ``use_flash`` (the default) every attention layer without a window is
    one flash_attention call; windowed layers, and every layer without
    it, take the reference's split between full scores and the chunked
    path.  Differentiable in the parameters that require a gradient;
    with ``cfg.remat`` and a graph to record, each full period of the
    block pattern is checkpointed (its activations recomputed in the
    backward), the tail's blocks are not.  Where nothing requires a
    gradient (serving) it runs with grad mode off, as ``decode_step``
    does: the eager per-step loops (the sLSTM's) would otherwise pay
    autograd's dispatch on every op."""
    cfg = model.cfg
    graph = torch.is_grad_enabled() and (
        (embeddings is not None and embeddings.requires_grad)
        or any(q.requires_grad for q in model.parameters()))
    with torch.set_grad_enabled(graph):
        if embeddings is not None:
            x = embeddings.to(_dtype(cfg))
            if tokens is not None:
                x = torch.cat([x, model.embed[tokens]], dim=1)
        else:
            x = model.embed[tokens]
        x = constrain(x, _layout(cfg))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        aux = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
                for k in ("aux_loss", "drop_frac")} if cfg.is_moe else None)
        p = len(period_pattern(cfg))
        n_stacked = cfg.n_layers // p * p
        with tagged("tagscan_layers_fwd", n_stacked // p):
            for i in range(0, n_stacked, p):
                args = (cfg, model.blocks[i:i + p], x, positions,
                        mrope_positions, aux, use_flash)
                x, aux = (checkpoint(_run_period, *args, use_reentrant=False)
                          if graph and cfg.remat else _run_period(*args))
        x, aux = _run_period(cfg, model.blocks[n_stacked:], x, positions,
                             mrope_positions, aux, use_flash)
        x = L.rms_norm(x, model.out_norm, cfg.norm_eps)
        x = constrain(x, ("batch", None, None))    # gather seq for the head
        logits = constrain(x @ model.w_out(), ("batch", None, "vocab"))
        return logits, (aux or {})


def train_loss(model: Model, batch: dict, *, use_flash: bool = True):
    """Next-token (or frame-classification, for encoder-only) loss of
    ``batch`` (``tokens``, ``embeddings``, ``mrope_positions`` as
    :func:`forward` takes them; ``labels`` and ``mask`` cover the whole
    sequence).  Returns (total, metrics): total is the mean NLL plus, for
    MoE, the summed ``aux_loss``; metrics hold ``nll`` and, for MoE,
    ``aux_loss`` and ``drop_frac``."""
    logits, aux = forward(model, batch.get("tokens"),
                          embeddings=batch.get("embeddings"),
                          mrope_positions=batch.get("mrope_positions"),
                          use_flash=use_flash)
    loss = L.cross_entropy(logits, batch["labels"], batch["mask"])
    total = loss + aux["aux_loss"] if aux else loss
    return total, {"nll": loss, **aux}


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def _layer_state(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                 dev) -> dict:
    dt = _dtype(cfg)
    if kind in ("attn", "local"):
        s = min(cfg.local_window, max_seq) if kind == "local" else max_seq
        shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}
    if kind == "rglru":
        return {"h": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((batch, cfg.conv1d_width - 1,
                                     cfg.d_model), dtype=dt, device=dev)}
    if kind == "mlstm":
        return XL.init_mlstm_state(cfg, batch, dev)
    return XL.init_slstm_state(cfg, batch, dev)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> list[dict]:
    """One cache per layer, on the card unless ``device="cpu"``: a
    ``{"k", "v"}`` ring buffer of (batch, S, Hk, Dh) in ``cfg.dtype``
    (S = max_seq, or min(local_window, max_seq) for a local layer);
    ``{"h"}`` f32 and ``{"conv"}`` (batch, W-1, d) in ``cfg.dtype`` for
    an RG-LRU layer; the f32 mLSTM ``{"C", "n", "m"}`` and sLSTM
    ``{"c", "n", "h", "m"}`` states."""
    dev = resolve_device(device)
    return [_layer_state(cfg, kind, batch, max_seq, dev)
            for kind in layer_kinds(cfg)]


def decode_state_axes(cfg: ModelConfig) -> list[dict]:
    """The logical axes of :func:`init_decode_state`'s caches, one dict a
    layer.  KV caches split their sequence over "kv_seq" (the split-K
    decode layout: kv-head counts of 1 to 8 are below a 16-way tensor
    axis); recurrent states split their channels over "tensor"."""

    def one(kind):
        if kind in ("attn", "local"):
            kv = ("batch", "kv_seq", None, None)
            return {"k": kv, "v": kv}
        if kind == "rglru":
            return {"h": ("batch", "tensor"),
                    "conv": ("batch", None, "tensor")}
        if kind == "mlstm":
            return {"C": ("batch", "tensor", None, None),
                    "n": ("batch", "tensor", None),
                    "m": ("batch", "tensor")}
        ax = ("batch", "tensor")
        return {"c": ax, "n": ax, "h": ax, "m": ax}

    return [one(kind) for kind in layer_kinds(cfg)]


def _decode_block(cfg: ModelConfig, p: Block, cache: dict, x, pos):
    kind = p.kind
    h = L.rms_norm(x, p.norm1, cfg.norm_eps)
    if kind in ("attn", "local"):
        window = cfg.local_window if kind == "local" else None
        out, ck, cv = L.run_attention_decode(p.attn, cfg, h, cache["k"],
                                             cache["v"], pos, window=window)
        cache = {"k": ck, "v": cv}
        x = x + out
        h2 = L.rms_norm(x, p.norm2, cfg.norm_eps)
        if cfg.is_moe:
            x = x + MOE.run_moe(p.moe, cfg, h2)[0]
        elif cfg.d_ff > 0:
            x = x + L.run_ffn(p.ffn, h2)
    elif kind == "rglru":
        out, (hh, conv) = RG.run_rglru_decode(p.rglru, cfg, h,
                                              (cache["h"], cache["conv"]))
        cache = {"h": hh, "conv": conv}
        x = x + out
        if cfg.d_ff > 0:
            x = x + L.run_ffn(p.ffn, L.rms_norm(x, p.norm2, cfg.norm_eps))
    elif kind == "mlstm":
        out, cache = XL.run_mlstm_decode(p.mlstm, cfg, h, cache)
        x = x + out
    else:
        out, cache = XL.run_slstm_decode(p.slstm, cfg, h, cache)
        x = x + out
    return x, cache


@torch.no_grad()
def decode_step(model: Model, state: list[dict], token: torch.Tensor, pos):
    """One token for the whole stack.  token (B, 1) int; pos is (B,)
    per-sequence positions or a scalar (synchronized batch decode).
    Returns (logits (B, V), state): attention caches are updated in place
    and returned, recurrent states replaced.  As in the reference, decode
    takes no M-RoPE positions: a vlm decodes with plain RoPE."""
    cfg = model.cfg
    x = model.embed[token]
    pos = torch.as_tensor(pos, device=x.device)   # one copy, not one a layer
    p = len(period_pattern(cfg))
    n_stacked = cfg.n_layers // p * p
    new_state = []
    with tagged("tagscan_layers_dec", n_stacked // p):
        for blk, cache in zip(model.blocks[:n_stacked], state[:n_stacked]):
            x, cache = _decode_block(cfg, blk, cache, x, pos)
            new_state.append(cache)
    for blk, cache in zip(model.blocks[n_stacked:], state[n_stacked:]):
        x, cache = _decode_block(cfg, blk, cache, x, pos)
        new_state.append(cache)
    x = L.rms_norm(x, model.out_norm, cfg.norm_eps)
    return (x @ model.w_out())[:, 0], new_state
