"""qwen2-vl-2b — M-RoPE; dynamic-resolution patch frontend stubbed per brief
[arXiv:2409.12191 [hf]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    mrope=True, mrope_sections=(16, 24, 24),
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="qwen2-vl-2b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    dtype="float32",
    remat=False,
    mrope=True, mrope_sections=(4, 6, 6),
)
