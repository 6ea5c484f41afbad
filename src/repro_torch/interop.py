"""Parameter conversion from the JAX package's layout.

``params_from_jax`` takes a JAX parameter tree whose leaves are numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the same
nested dict paths, the same shapes and dtypes, as tensors on ``device``.
bfloat16 leaves go through float32, which is exact.  Nothing here imports
JAX: the caller does the ``np.asarray``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

PyTree = Any


def _leaf(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: numpy has no native one
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(tree: PyTree, device: DeviceLike = "cuda") -> PyTree:
    """The port's parameter tree for a JAX parameter tree of arrays."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _leaf(node, dev)

    return convert(tree)
