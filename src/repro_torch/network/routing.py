"""Dimension-ordered routing (DOR) link loads on a torus (port of the
torus part of ``repro.network.routing``).

:func:`route_dor` is the JAX package's ``route_dor(..., backend="xla")``:
the per-directed-link load tensor of a message batch, computed by
:func:`repro_torch.network.backend.route_loads` on ``device``.  Ties (a
ring distance of exactly half the ring) split their volume across both
directions with ``split_ties=True``; a dimension of length 2 has two
parallel links under the Blue Gene/Q convention, which
:func:`max_link_load` applies at query time.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.network.backend import route_loads


def route_dor(
    dims: Sequence[int],
    src: np.ndarray,
    dst: np.ndarray,
    vol,
    split_ties: bool = True,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Per-directed-link loads ``(D, 2, *dims)`` of messages ``src -> dst``
    ((M, D) int arrays) with volumes ``vol`` ((M,) or a scalar); equal to
    the JAX package's tensor exactly for integer or dyadic volumes."""
    return route_loads(dims, src, dst, vol, split_ties=split_ties, device=device)


def max_link_load(dims: Sequence[int], loads: np.ndarray, double_link_on_2: bool = True) -> float:
    """Maximum per-physical-link load of a :func:`route_dor` result.

    Under the Blue Gene/Q convention a dimension of length 2 has two parallel
    links per vertex pair and traffic balances across them, halving the
    effective load; TPU-style fabrics pass ``double_link_on_2=False``.
    """
    dims = tuple(dims)
    m = 0.0
    for k, a in enumerate(dims):
        if a == 1:
            continue
        scale = 0.5 if (a == 2 and double_link_on_2) else 1.0
        m = max(m, scale * float(loads[k].max()))
    return m
