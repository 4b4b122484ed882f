from .base import ModelConfig, MoEConfig, all_configs, get_config, register
from . import granite_8b  # noqa: F401  — populates the registry

__all__ = ["ModelConfig", "MoEConfig", "get_config", "all_configs", "register"]
