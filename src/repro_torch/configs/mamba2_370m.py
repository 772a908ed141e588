"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280, state=128.

SSD (state-space duality). [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=128),
)

REDUCED = ModelConfig(
    name="mamba2-370m-reduced",
    family="ssm",
    num_layers=2,
    d_model=64,
    vocab=256,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16),
)
