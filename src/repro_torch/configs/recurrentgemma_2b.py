"""recurrentgemma-2b — RG-LRU + local attention, 1:2
[arXiv:2402.19427 [hf]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rglru", "rglru", "local"), local_window=2048,
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="recurrentgemma-2b-reduced",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=512,
    dtype="float32",
    remat=False,
    block_pattern=("rglru", "rglru", "local"), local_window=8,
)
