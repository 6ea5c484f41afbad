"""Checkpoints of the port, in the JAX package's format (counterpart of
``repro.checkpoint``)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
