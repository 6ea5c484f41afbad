"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel lives in ``<name>/csrc/*.cu`` beside ``<name>/ref.py`` (the plain
version) and ``<name>/ops.py`` (the wrapper); ``_build`` compiles the sources
with ``nvcc`` at first use.
"""

from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record this call.  The forward wrappers
    have no backward (nor had the TPU kernels they replace; flash
    attention's backward is ``attention.ops.FlashAttention``, which the
    ``torch`` paths take): on the card a wrapper
    writes its output through ``ctypes``, so that output has no
    ``grad_fn`` and every gradient upstream of the call would be lost
    without a word.  The check runs on both devices, so that a CPU test
    catches what the card would do silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward pass: call it under torch.no_grad() or "
            "torch.inference_mode(), or take the model's impl='torch' paths to train"
        )
