"""Atomic, asynchronous checkpointing in the reference's on-disk layout."""

from repro_torch.checkpoint.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
