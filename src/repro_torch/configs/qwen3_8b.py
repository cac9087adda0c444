"""qwen3-8b — qk_norm + GQA
[hf:Qwen/Qwen3-8B [hf]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="qwen3-8b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    dtype="float32",
    remat=False,
    qk_norm=True,
)
