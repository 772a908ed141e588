"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global sliding-window pattern (window 1024), head_dim=256, 128k
context (sub-quadratic in 5/6 layers -> long_500k runs). [hf:google/gemma-3]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    sliding_window=1024,
    local_global_pattern=(5, 1),
    act="gelu",
    tied_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma3-4b-reduced",
    family="dense",
    num_layers=3,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    sliding_window=8,
    local_global_pattern=(2, 1),
    act="gelu",
    tied_embeddings=True,
)
