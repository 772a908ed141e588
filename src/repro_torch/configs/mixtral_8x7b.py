"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

8 experts top-2, sliding-window attention (4096) -> sub-quadratic, long_500k
runs. [arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    tied_embeddings=False,
)

REDUCED = ModelConfig(
    name="mixtral-8x7b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    sliding_window=16,
    moe=MoEConfig(num_experts=4, top_k=2),
    tied_embeddings=False,
)
