"""LM scaffolding, dense family: ``config`` (``ModelConfig``), ``layers``
(norms, RoPE, attention through the flash_attention kernel, SwiGLU) and
``model`` (``init_model``, ``forward``, ``init_decode_state``,
``decode_step``)."""

from .config import ModelConfig, layer_kinds
from .model import (
    Model,
    decode_step,
    forward,
    init_decode_state,
    init_model,
)

__all__ = ["Model", "ModelConfig", "decode_step", "forward",
           "init_decode_state", "init_model", "layer_kinds"]
