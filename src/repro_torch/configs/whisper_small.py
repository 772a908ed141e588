"""whisper-small [audio]: enc-dec, conv frontend stubbed (precomputed frames).

12L decoder + 12L encoder, d_model=768, 12H MHA, d_ff=3072, vocab=51865.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    vocab=51865,
    encoder_layers=12,
    encoder_len=1500,          # 30 s audio -> 3000 mel frames -> conv stride 2
    qkv_bias=True,             # whisper uses bias on attention projections
    act="gelu",
    glu=False,
)

REDUCED = ModelConfig(
    name="whisper-small-reduced",
    family="encdec",
    num_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    encoder_layers=2,
    encoder_len=16,
    qkv_bias=True,
    act="gelu",
    glu=False,
)
