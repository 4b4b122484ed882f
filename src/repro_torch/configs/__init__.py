from .base import (SHAPES, ModelConfig, MoEConfig, ShapeConfig, all_configs,
                   get_config, register)
from . import archs  # noqa: F401  — populates the registry

__all__ = ["ModelConfig", "MoEConfig", "ShapeConfig", "SHAPES", "get_config",
           "all_configs", "register"]
