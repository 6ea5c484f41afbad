"""Traffic-aware placement scoring (port of the contention-field part of
``repro.network.placement``).

A job's all-to-all load field translates with its placement offset on the
torus, so its overlap with the links a new job should avoid (those leaving
occupied cells, or carrying background traffic) is a circular
cross-correlation over every offset at once: :func:`contention_field`,
computed by :func:`repro_torch.network.backend.contention_field` on
``device``.  The JAX package's ``best_placement`` ranks offsets on it
after rounding to 9 decimals; the search itself (``best_placement``,
``first_fit``, the occupancy windows) is not ported.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network import backend
from repro_torch.network.geometry import Geometry, canonical
from repro_torch.network.routing import route_dor

Coord = Tuple[int, ...]

__all__ = [
    "base_loads",
    "contention_field",
    "interference_mask",
    "orientations",
    "pad_geometry",
    "placement_all_to_all_traffic",
]


def pad_geometry(geometry: Sequence[int], ndim: int) -> Geometry:
    """Canonicalise and pad a requested geometry to the machine's rank.

    Trailing 1s beyond the machine rank are harmless and stripped; a
    geometry with more *non-trivial* dimensions than the machine is an
    error.
    """
    g = canonical(geometry)
    while len(g) > ndim and g[-1] == 1:
        g = g[:-1]
    if len(g) > ndim:
        raise ValueError(
            f"geometry {canonical(geometry)} has {len(g)} non-trivial dims; "
            f"machine has only {ndim}"
        )
    return g + (1,) * (ndim - len(g))


def orientations(geometry: Sequence[int], dims: Sequence[int]) -> List[Tuple[int, ...]]:
    """Distinct axis-assignments of the cuboid that fit the machine, in the
    reference scan's order: ``sorted(set(permutations(padded)))``."""
    dims = tuple(dims)
    g = pad_geometry(geometry, len(dims))
    return [
        perm
        for perm in sorted(set(itertools.permutations(g)))
        if all(s <= a for s, a in zip(perm, dims))
    ]


def _relative_cells(oriented: Tuple[int, ...]) -> np.ndarray:
    n = int(np.prod(oriented))
    return np.stack(np.unravel_index(np.arange(n), oriented), axis=1).astype(np.int64)


def placement_all_to_all_traffic(
    dims: Sequence[int], oriented: Sequence[int], offset: Coord
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Intra-job all-to-all in machine coordinates, volume ``1/n`` per
    ordered pair so every cell injects ~unit volume regardless of job size.

    This is the contention-scoring pattern: messages between cells at
    within-span distance beyond half the ring route the short way around —
    *through* foreign territory — so placements with long spans genuinely
    load links that other placements use.
    """
    dims = tuple(int(a) for a in dims)
    oriented = tuple(int(w) for w in oriented)
    n = int(np.prod(oriented))
    rel = _relative_cells(oriented)
    off = np.asarray(offset, dtype=np.int64)
    d = np.asarray(dims, dtype=np.int64)
    cells = (rel + off) % d
    si = np.repeat(np.arange(n), n)
    di = np.tile(np.arange(n), n)
    keep = si != di
    si, di = si[keep], di[keep]
    vol = np.full(si.shape[0], 1.0 / n, dtype=np.float64)
    return cells[si], cells[di], vol


def base_loads(dims: Sequence[int], oriented: Sequence[int], device: DeviceLike = "cuda") -> np.ndarray:
    """The job's all-to-all load field for a placement at the origin,
    routed by :func:`repro_torch.network.routing.route_dor` on ``device``.
    Loads translate with the placement, so this one field serves every
    offset of the orientation."""
    dims = tuple(int(a) for a in dims)
    src, dst, vol = placement_all_to_all_traffic(dims, oriented, (0,) * len(dims))
    if src.shape[0] == 0:
        resolve_device(device)
        return np.zeros((len(dims), 2) + dims)
    return route_dor(dims, src, dst, vol, device=device)


def interference_mask(
    grid: np.ndarray, background_loads: Optional[np.ndarray] = None
) -> np.ndarray:
    """(D, 2, *dims) boolean mask of links a new job should avoid loading:
    links leaving an occupied cell (transit through foreign territory —
    interference whether or not the owner is routing there *right now*),
    plus links already carrying background traffic (e.g. a neighbour's
    spill over free corridor cells)."""
    D = len(grid.shape)
    mask = np.broadcast_to(grid.astype(bool), (D, 2) + grid.shape).copy()
    if background_loads is not None:
        mask |= background_loads > 0.0
    return mask


def contention_field(
    dims: Sequence[int], oriented: Sequence[int], mask: np.ndarray, device: DeviceLike = "cuda"
) -> np.ndarray:
    """Predicted interference for every offset of an orientation: the job's
    traffic volume over masked links (:func:`interference_mask`),

        C[o] = sum_{k,d,v} J[k,d][(v - o) mod dims] * mask[k,d][v],

    one batched FFT cross-correlation on ``device``.  Values carry FFT
    round-off (~1e-12); the JAX package's ``best_placement`` ranks them
    after rounding to 9 decimals."""
    dims = tuple(int(a) for a in dims)
    J = base_loads(dims, tuple(int(w) for w in oriented), device=device)
    return backend.contention_field(mask, J, device=device)
