"""Architecture configs of the port, one module per ported architecture.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
"""
from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, get_config,
                   get_smoke_config, shape_skips)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "get_smoke_config", "shape_skips"]
