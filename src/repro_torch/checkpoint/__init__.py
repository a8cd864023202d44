"""Checkpoints of tensor trees (``manager.CheckpointManager``): the port's
counterpart of ``repro.checkpoint``."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
