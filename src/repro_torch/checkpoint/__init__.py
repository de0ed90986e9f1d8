"""Atomic, async checkpoints in the JAX package's on-disk format."""

from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
