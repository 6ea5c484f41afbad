"""The port's model stack: layers, the dense transformer and the Model API."""

from .model import Model, build_model, cross_entropy, synthetic_batch

__all__ = ["Model", "build_model", "cross_entropy", "synthetic_batch"]
