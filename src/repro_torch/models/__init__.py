"""Model zoo of the port: the dense, vlm and moe decoders in PyTorch."""

from .common import RuntimeFlags
from .model import Model, build_model

__all__ = ["Model", "RuntimeFlags", "build_model"]
