"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

Llama-arch small model; also the end-to-end ~100M training example arch.
[hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    n_heads=9,
    n_kv=3,
    d_ff=1536,
    vocab=49152,
    tied_embeddings=True,
)

REDUCED = ModelConfig(
    name="smollm-135m-reduced",
    family="dense",
    num_layers=3,
    d_model=96,
    n_heads=3,
    n_kv=1,
    d_ff=256,
    vocab=512,
    tied_embeddings=True,
)
