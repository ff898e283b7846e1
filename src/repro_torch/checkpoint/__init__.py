"""Fault-tolerant checkpointing (the reference's on-disk format)."""
from .checkpoint import (
    FORMAT_VERSION,
    CheckpointManager,
    save_checkpoint,
    restore_checkpoint,
    restore_latest,
    list_checkpoints,
)

__all__ = [
    "FORMAT_VERSION",
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "restore_latest",
    "list_checkpoints",
]
