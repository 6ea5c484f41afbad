"""Torus geometry helpers the network passes need (copies of
``repro.network.geometry.volume`` / ``canonical`` and of
``repro.network.isoperimetry._divisors``).

Geometries are canonicalised in sorted-descending order, as in the paper:
partitions identical up to rotation are one geometry.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import numpy as np

Geometry = Tuple[int, ...]


def canonical(dims: Iterable[int]) -> Geometry:
    """Sorted-descending canonical form of a torus/cuboid geometry."""
    out = tuple(sorted((int(d) for d in dims), reverse=True))
    if any(d < 1 for d in out):
        raise ValueError(f"dimension lengths must be >= 1, got {out}")
    return out


def volume(dims: Iterable[int]) -> int:
    """Vertex count of the torus/cuboid: the product of dimension lengths."""
    return math.prod(dims)


def _divisors(t: int, cap: Optional[int] = None) -> np.ndarray:
    """Divisors of t, optionally only those <= cap (a side can never exceed
    the longest torus dimension, so the enumeration caps there)."""
    hi = t if cap is None else min(t, cap)
    d = np.arange(1, hi + 1, dtype=np.int64)
    return d[t % d == 0]
