"""Model zoo of the port in PyTorch: every family of the JAX package (dense,
vlm, moe, hybrid, ssm and enc-dec)."""

from .common import RuntimeFlags
from .model import Model, build_model

__all__ = ["Model", "RuntimeFlags", "build_model"]
