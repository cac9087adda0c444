"""LM scaffolding, every family: ``config`` (``ModelConfig``), ``layers``
(norms, RoPE and M-RoPE, attention through the flash_attention kernel,
SwiGLU), ``moe``, ``rglru`` and ``xlstm`` (the MoE FFN, the RG-LRU and
xLSTM blocks) and ``model`` (``init_model``, ``forward``,
``init_decode_state``, ``decode_step``, ``train_loss``)."""

from .config import ModelConfig, layer_kinds
from .model import (
    Model,
    decode_step,
    forward,
    init_decode_state,
    init_model,
    train_loss,
)

__all__ = ["Model", "ModelConfig", "decode_step", "forward",
           "init_decode_state", "init_model", "layer_kinds", "train_loss"]
