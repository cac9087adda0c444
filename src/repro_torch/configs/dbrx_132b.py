"""dbrx-132b — 16 experts top-4
[hf:databricks/dbrx-base [unverified]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16, top_k=4,
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="dbrx-132b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    dtype="float32",
    remat=False,
    n_experts=4, top_k=2,
)
