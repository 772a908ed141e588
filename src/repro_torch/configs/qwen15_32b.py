"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.

QKV bias. [hf:Qwen/Qwen1.5-* family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    tied_embeddings=False,
)

REDUCED = ModelConfig(
    name="qwen1.5-32b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=160,
    vocab=256,
    qkv_bias=True,
    tied_embeddings=False,
)
