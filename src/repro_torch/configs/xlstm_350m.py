"""xlstm-350m — alternating sLSTM/mLSTM
[arXiv:2405.04517 [unverified]]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    
)

# Reduced same-family config for CPU smoke tests.
REDUCED = ModelConfig(
    name="xlstm-350m-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=512,
    dtype="float32",
    remat=False,
    
)
