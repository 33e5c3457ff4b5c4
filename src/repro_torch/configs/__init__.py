"""The port's copy of ``repro.configs``: model and shape configs (data only)."""

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    cells,
    get_config,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
    "all_configs", "cells", "get_config",
]
