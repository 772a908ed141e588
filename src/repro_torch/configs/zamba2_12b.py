"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000.

Mamba2 backbone + a shared full-attention block applied every 6 layers
(ssm_state=64). SSM-dominated -> long_500k runs. [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=128),
    shared_attn_every=6,
    tied_embeddings=True,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    num_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    shared_attn_every=2,
    tied_embeddings=True,
)
