"""qwen3-14b — qk_norm + GQA
[hf:Qwen/Qwen3-8B [hf]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="qwen3-14b-reduced",
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
