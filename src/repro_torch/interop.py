"""State carried across from the JAX package.

``params_from_jax`` takes a JAX parameter tree whose leaves are numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's tree: the same
nested dict paths, the same shapes and dtypes, as tensors on ``device``.
bfloat16 leaves go through float32, which is exact.  ``flow_paths_from_numpy``
takes routed network paths.  Nothing here imports JAX or ``repro``: the
caller does the ``np.asarray``, and paths are read by their fields.
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


def flow_paths_from_numpy(obj):
    """The port's :class:`repro_torch.network.netsim.FlowPaths` for any
    object with the fields of the JAX package's ``FlowPaths`` (``dims``,
    ``n_messages``, ``msg``, ``vol``, ``link_ids``, ``flow_ids``, ``mode``
    and, for non-torus fabrics such as HyperX, ``capacities``)."""
    from repro_torch.network.netsim import FlowPaths

    caps = getattr(obj, "capacities", None)
    return FlowPaths(
        dims=tuple(int(a) for a in obj.dims),
        n_messages=int(obj.n_messages),
        msg=np.asarray(obj.msg, dtype=np.int64),
        vol=np.asarray(obj.vol, dtype=np.float64),
        link_ids=np.asarray(obj.link_ids, dtype=np.int64),
        flow_ids=np.asarray(obj.flow_ids, dtype=np.int64),
        mode=str(obj.mode),
        capacities=None if caps is None else np.asarray(caps, dtype=np.float64),
    )
