"""Staged, checksummed, atomic checkpoints in the JAX package's on-disk
format (:mod:`repro_torch.checkpoint.manager`)."""

from .manager import (CheckpointManager, CheckpointMeta, latest_step,
                      load_checkpoint, save_checkpoint, verify_checkpoint)

__all__ = ["CheckpointManager", "CheckpointMeta", "latest_step",
           "load_checkpoint", "save_checkpoint", "verify_checkpoint"]
