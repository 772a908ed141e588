"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.

SigLIP vision frontend is a stub: the caller passes 256 precomputed patch
embeddings, prepended to the text sequence. Gemma-2b text backbone
(head_dim=256). [arXiv:2407.07726]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    prefix_len=256,
    act="gelu",
    tied_embeddings=True,
)

REDUCED = ModelConfig(
    name="paligemma-3b-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=1,
    d_ff=128,
    vocab=256,
    head_dim=16,
    prefix_len=4,
    act="gelu",
    tied_embeddings=True,
)
