from .base import (SHAPES, SUBQUADRATIC, ModelConfig, MoEConfig, ShapeConfig,
                   all_configs, get_config, register, runnable_cells)
from . import archs  # noqa: F401  — populates the registry

__all__ = ["ModelConfig", "MoEConfig", "ShapeConfig", "SHAPES", "SUBQUADRATIC",
           "get_config", "all_configs", "register", "runnable_cells"]
