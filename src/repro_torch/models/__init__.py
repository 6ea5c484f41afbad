"""The port's model stack: layers, the transformer (dense, MoE, audio, VLM), the
zamba2 hybrid, the RWKV6 LM and the Model API."""

from .model import Model, build_model, cross_entropy, synthetic_batch

__all__ = ["Model", "build_model", "cross_entropy", "synthetic_batch"]
