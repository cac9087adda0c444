"""hubert-xlarge — encoder-only; frame-embedding frontend stubbed per brief
[arXiv:2106.07447 [unverified]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="hubert-xlarge-reduced",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    dtype="float32",
    remat=False,
    causal=False,
)
