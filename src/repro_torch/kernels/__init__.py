"""Hand-written Hopper kernels for the serving and training hot paths.

Each kernel ships three layers:
  ../csrc/<name>.cu — CUDA C++ for sm_90a, built by `_build` at first use
  <name>.py         — ctypes wrapper: checks, launch, launch count
  ref.py            — plain PyTorch version (CPU path, on-card yardstick)
and `ops.py` dispatches: CUDA tensor -> kernel, CPU tensor -> plain version.
rmsnorm also has a backward kernel (`rmsnorm_bwd`), which `ops.RMSNormFn`
pairs with the forward for autograd.
"""

from . import ops, ref
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .rmsnorm import rmsnorm, rmsnorm_bwd

__all__ = ["ops", "ref", "flash_attention", "decode_attention", "rmsnorm", "rmsnorm_bwd"]
