from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    reduced_config,
)
