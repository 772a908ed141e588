"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

GQA + QKV bias, tied embeddings. [arXiv:2407.10671]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tied_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen2-0.5b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tied_embeddings=True,
)
