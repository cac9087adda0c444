"""stablelm-1.6b — 
[hf:stabilityai/stablelm-2-1_6b [unverified]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="stablelm-1.6b-reduced",
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
