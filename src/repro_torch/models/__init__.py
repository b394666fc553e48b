"""Model zoo of the port: the dense decoder (llama2-7b) in PyTorch."""

from .common import RuntimeFlags
from .model import Model, build_model

__all__ = ["Model", "RuntimeFlags", "build_model"]
