"""Model configuration for the assigned architectures.

The port's copy of the reference package's ``models/config.py``, the same
in behaviour.  One frozen dataclass covers all six families (dense / moe
/ audio / hybrid / vlm / ssm); family-specific fields are ignored
elsewhere.  Configs for the ten assigned architectures live in
repro_torch.configs.<id>.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "audio", "hybrid", "vlm", "ssm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads

    # attention details
    causal: bool = True                  # False for encoder-only (audio)
    qk_norm: bool = False                # qwen3
    rope_theta: float = 10_000.0
    mrope: bool = False                  # qwen2-vl 3-component M-RoPE
    mrope_sections: tuple[int, ...] = (16, 24, 24)   # t/h/w splits of d_head/2

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # hybrid (recurrentgemma): per-layer pattern cycling through this tuple
    block_pattern: tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "local")
    local_window: int = 2048
    rglru_c: float = 8.0                 # Griffin's gate sharpness constant
    conv1d_width: int = 4

    # ssm (xlstm): alternating block kinds
    slstm_every: int = 2                 # every k-th block is sLSTM

    # MoE execution: process tokens through experts in chunks of this many
    # tokens (0 = all at once) — bounds the (E, C, d_ff) live intermediates
    # during prefill, where there is no remat to cap them.
    moe_token_chunk: int = 0
    # "gather" (baseline: replicated tokens + combine all-reduce) or "a2a"
    # (sequence-sharded dispatch/return all-to-alls — see
    # distributed/ep_a2a.py).  "a2a" requires an active mesh context.
    moe_impl: str = "gather"
    # Megatron-style sequence parallelism: the residual stream stays
    # sequence-sharded over the tensor axis; the gather/scatter flip
    # happens only around attention (norms/FFN/MoE run seq-sharded).
    seq_parallel: bool = False
    # Model the chunked-attention scans as the Pallas flash kernel
    # (kernels/flash_attention) in the dry-run byte accounting: chunk
    # intermediates are VMEM-resident; only q/k/v tile loads and output
    # tile writes hit HBM.
    flash_model: bool = False

    # embeddings / io
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # training
    remat: bool = True                   # activation checkpoint per block

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, \
            (self.n_heads, self.n_kv_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def params_total(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        return _count_params(self)

    @property
    def params_active(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        return _count_params(self, active_only=True)


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d, dh = cfg.d_model, cfg.d_head
    h, hk = cfg.n_heads, cfg.n_kv_heads
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    kinds = _layer_kinds(cfg)
    for kind in kinds:
        if kind in ("attn", "local"):
            per_layer += d * (h * dh) + 2 * d * (hk * dh) + (h * dh) * d
        elif kind == "rglru":
            # in/gate/out projections + conv + recurrence params
            per_layer += 3 * d * d + cfg.conv1d_width * d + 2 * d
        elif kind == "mlstm":
            per_layer += 4 * d * d + 3 * d * d // 1  # qkv+o + gates
        elif kind == "slstm":
            per_layer += 8 * d * d // 4  # 4 gates, head-blocked
        # FFN part
        if kind in ("attn", "local"):
            if cfg.is_moe:
                experts = cfg.top_k if active_only else cfg.n_experts
                per_layer += experts * 3 * d * cfg.d_ff + d * cfg.n_experts
            elif cfg.d_ff > 0:
                per_layer += 3 * d * cfg.d_ff
        elif kind == "rglru" and cfg.d_ff > 0:
            per_layer += 3 * d * cfg.d_ff
    return emb + per_layer + cfg.n_layers * 2 * d  # norms


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    """Per-layer block kind according to family."""
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rglru", "rglru", "local")
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    if cfg.family == "ssm":
        return ["slstm" if (i % cfg.slstm_every == cfg.slstm_every - 1)
                else "mlstm" for i in range(cfg.n_layers)]
    return ["attn"] * cfg.n_layers


def layer_kinds(cfg: ModelConfig) -> list[str]:
    return _layer_kinds(cfg)
