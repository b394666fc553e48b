"""Training substrate (counterpart of `repro/training`): optimizer, synthetic
data, checkpoints in the reference's format, loop."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .data import DataConfig, SyntheticLM
from .loop import make_train_step, model_batch, train_loop
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = [
    "AdamWConfig",
    "DataConfig",
    "SyntheticLM",
    "adamw_init",
    "adamw_update",
    "latest_step",
    "make_train_step",
    "model_batch",
    "restore_checkpoint",
    "save_checkpoint",
    "train_loop",
]
