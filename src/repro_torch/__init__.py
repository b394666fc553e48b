"""PyTorch/CUDA port of `repro` (JAX + Pallas), laid out like it.

The port imports torch, numpy and the standard library only: no JAX and
nothing of `repro`. Its entry points run on the card (`device="cuda"`) and
raise when there is none, unless the caller passes `device="cpu"`.

The main path: configs -> kernels (rmsnorm, flash_attention,
decode_attention) -> models (every family of the JAX package) -> serving
(engine, ICC scheduling, calibration) -> launch.serve; the measured
service time -> core (the paper's slot simulator, numpy) -> launch.capacity;
and training (loss, rmsnorm's backward kernel, AdamW, checkpoints) ->
launch.train.
"""

from .configs import ModelConfig, get_config
from .models import Model, RuntimeFlags, build_model

__all__ = ["ModelConfig", "get_config", "Model", "RuntimeFlags", "build_model"]
