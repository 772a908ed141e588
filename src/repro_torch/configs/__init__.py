from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    get_config,
    reduced_config,
)
from repro_torch.configs.shapes import SHAPE_IDS, SHAPES, get_shape  # noqa: F401
