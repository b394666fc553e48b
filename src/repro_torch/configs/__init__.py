"""Architecture configs the port can run.

``get_config("glm4-9b")`` -> full-size config;
``get_config(name, smoke=True)`` -> reduced same-family variant for CPU.
"""

from .base import ModelConfig, get_config, list_configs, register, smoke_variant

__all__ = ["ModelConfig", "get_config", "list_configs", "register", "smoke_variant"]
