"""Checkpointing: npz save/restore with a manifest and an async writer."""
from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]
