"""moonshot-v1-16b-a3b — fine-grained 64-expert top-6 MoE (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B [hf]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    n_experts=64, top_k=6,
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="moonshot-v1-16b-a3b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    dtype="float32",
    remat=False,
    n_experts=8, top_k=2,
)
