"""PyTorch/CUDA port of `repro` (JAX + Pallas), laid out like it.

The port imports torch, numpy and the standard library only: no JAX and
nothing of `repro`. Its entry points run on the card (`device="cuda"`) and
raise when there is none, unless the caller passes `device="cpu"`.

This slice serves the dense decoder (llama2-7b) end to end:
configs -> kernels (rmsnorm, flash_attention, decode_attention) -> models
-> serving (engine, ICC scheduling, calibration) -> launch.serve.
"""

from .configs import ModelConfig, get_config
from .models import Model, RuntimeFlags, build_model

__all__ = ["ModelConfig", "get_config", "Model", "RuntimeFlags", "build_model"]
