"""phi3-mini-3.8b — RoPE SwiGLU, MHA-equal GQA
[arXiv:2404.14219 [unverified]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="phi3-mini-3.8b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    dtype="float32",
    remat=False,
    
)
