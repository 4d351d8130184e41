"""Atomic, async checkpoints of torch tensor trees (the JAX package's
``ckpt`` on torch tensors)."""
from .checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint"]
