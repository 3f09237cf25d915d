"""Architecture & input-shape configs (one module per assigned architecture)."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    LONG_CONTEXT_WINDOW,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    all_configs,
    canon,
    config_for_shape,
    get_config,
    get_smoke_config,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "LONG_CONTEXT_WINDOW", "InputShape",
    "ModelConfig", "MoEConfig", "SSMConfig", "all_configs", "canon",
    "config_for_shape", "get_config", "get_smoke_config", "shape_applicable",
]
