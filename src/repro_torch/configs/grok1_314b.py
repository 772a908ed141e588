"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.

8 experts top-2, head_dim=128. Largest assigned config — exercises
FSDP x TP x EP x pod sharding the hardest. [hf:xai-org/grok-1]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2),
    tied_embeddings=True,
)

REDUCED = ModelConfig(
    name="grok-1-314b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=2),
    tied_embeddings=True,
)
