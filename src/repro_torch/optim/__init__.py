"""Optimizer and gradient compression of the port (counterpart of
``repro.optim``)."""

from . import compression
from .adamw import AdamWConfig, AdamWState, global_norm, init, schedule, update

__all__ = ["AdamWConfig", "AdamWState", "compression", "global_norm", "init", "schedule", "update"]
