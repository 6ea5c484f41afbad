"""Canonical torus/cuboid geometry (the port's copy of
``repro.network.geometry``, with ``ExplicitTorus``, its brute-force
oracle), plus ``repro.network.isoperimetry._divisors``.

Conventions:

* a torus is its dimension lengths ``dims = (a_1, ..., a_D)``;
* geometries are canonicalised in sorted-descending order, as in the
  paper: partitions identical up to rotation are one geometry;
* a dimension of length 2 is a double link under the Blue Gene/Q
  convention (both neighbours coincide, two parallel edges); TPU-style
  single links live in :class:`repro_torch.network.fabric.TorusFabric`;
* dimensions of length 1 contribute no edges.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

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


def degree_contribution(length: int) -> int:
    """Edges incident to a vertex along one torus dimension of given length."""
    if length == 1:
        return 0
    return 2  # length==2 is a double link; still two edge-endpoints per vertex.


def degree(dims: Sequence[int]) -> int:
    """Vertex degree of the (regular) torus with the given dimension lengths."""
    return sum(degree_contribution(a) for a in dims)


def num_edges(dims: Sequence[int]) -> int:
    """Undirected edge count, honouring the double-link convention for a==2."""
    total = 0
    n = volume(dims)
    for a in dims:
        if a == 1:
            continue
        lines = n // a
        edges_per_line = a if a > 2 else 2
        total += lines * edges_per_line
    return total


# ---------------------------------------------------------------------------
# Cuboid containment / cut / interior.
# ---------------------------------------------------------------------------
def contains_cuboid(torus_dims: Sequence[int], cuboid: Sequence[int]) -> bool:
    """Whether a cuboid geometry fits in the torus (up to rotation)."""
    t = canonical(torus_dims)
    c = canonical(cuboid)
    if len(c) > len(t):
        return False
    c = c + (1,) * (len(t) - len(c))
    # Greedy matching on sorted-descending lists is exact here: match the
    # largest cuboid side to the smallest torus side that still fits.
    avail = list(t)
    for side in c:
        candidates = [i for i, a in enumerate(avail) if a >= side]
        if not candidates:
            return False
        best = min(candidates, key=lambda i: avail[i])
        avail.pop(best)
    return True


def cuboid_cut(torus_dims: Sequence[int], cuboid: Sequence[int]) -> int:
    """|E(S, S̄)| for a cuboid subset S, counting double links for a_i == 2.

    A side s_i embedded in torus dimension a_i contributes 0 edges if
    s_i == a_i (wrap-around links are internal) and 2 |S| / s_i otherwise;
    the minimum over all feasible embeddings is the canonical geometry's
    cut.
    """
    t = canonical(torus_dims)
    c = list(canonical(cuboid))
    if len(c) > len(t):
        raise ValueError(f"cuboid {c} has more dims than torus {t}")
    c = c + [1] * (len(t) - len(c))
    if not contains_cuboid(t, c):
        raise ValueError(f"cuboid {tuple(c)} does not fit in torus {t}")
    size = volume(c)
    best = None
    for perm in set(itertools.permutations(c)):
        if any(s > a for s, a in zip(perm, t)):
            continue
        cut = sum(2 * size // s for s, a in zip(perm, t) if s != a)
        best = cut if best is None else min(best, cut)
    assert best is not None
    return best


def cuboid_cut_aligned(torus_dims: Sequence[int], sides: Sequence[int]) -> int:
    """Cut of a cuboid with side i embedded along torus dimension i
    (no canonicalisation — for validation against explicit placements)."""
    t = tuple(int(a) for a in torus_dims)
    s = tuple(sides) + (1,) * (len(t) - len(tuple(sides)))
    if any(x > a for x, a in zip(s, t)):
        raise ValueError(f"aligned cuboid {s} does not fit in {t}")
    size = volume(s)
    return sum(2 * size // x for x, a in zip(s, t) if x != a)


def cuboid_interior(torus_dims: Sequence[int], cuboid: Sequence[int]) -> int:
    """|E(S, S)| for a cuboid subset, via the regularity identity (Eq. 1):
    k*|S| = 2|E(S,S)| + |E(S, S̄)| for a k-regular graph."""
    t = canonical(torus_dims)
    c = canonical(tuple(cuboid) + (1,) * (len(t) - len(tuple(cuboid))))
    size = volume(c)
    k = degree(t)
    cut = cuboid_cut(t, c)
    twice_interior = k * size - cut
    assert twice_interior % 2 == 0
    return twice_interior // 2


def sub_cuboids(torus_dims: Sequence[int], size: int) -> Iterator[Geometry]:
    """All canonical cuboid geometries of a given vertex count that fit."""
    t = canonical(torus_dims)
    seen = set()
    for c in factorizations(size, len(t)):
        if c in seen:
            continue
        seen.add(c)
        if contains_cuboid(t, c):
            yield c


def bisection_links(dims: Sequence[int]) -> int:
    """Internal bisection of a fully-wrapped torus in links: 2 N / L for an
    even longest dimension L (the paper's Blue Gene/Q formula); for an odd
    one, the exact minimum cut over floor(N/2)-sized cuboids, or the
    Theorem 3.1 bound when none exists."""
    t = canonical(dims)
    n = volume(t)
    if n == 1:
        return 0
    L = t[0]
    if L % 2 == 0:
        return 2 * n // L
    if L == 1:
        return 0
    target = n // 2
    best = None
    for c in sub_cuboids(t, target):
        cut = cuboid_cut(t, c)
        best = cut if best is None else min(best, cut)
    if best is None:
        best = math.ceil(theorem31_bound(t, target))
    return best


def theorem31_bound(dims: Sequence[int], t: int) -> float:
    """Theorem 3.1: the generalized edge-isoperimetric lower bound on the
    cut of any size-t subset,

        min_{r in 0..D-1} 2 (D - r) (prod of the r smallest dims)^(1/(D-r))
                          t^((D-r-1)/(D-r)).
    """
    a = canonical(dims)
    n = volume(a)
    if t < 0 or t > n // 2:
        raise ValueError(f"t must satisfy 0 <= t <= |V|/2 = {n // 2}, got {t}")
    if t == 0:
        return 0.0
    D = len(a)
    best = math.inf
    for r in range(D):
        k = math.prod(a[D - r:]) if r > 0 else 1  # product of r smallest dims
        val = 2.0 * (D - r) * k ** (1.0 / (D - r)) * t ** ((D - r - 1.0) / (D - r))
        best = min(best, val)
    return best


# ---------------------------------------------------------------------------
# Enumeration.
# ---------------------------------------------------------------------------
def factorizations(n: int, max_parts: int) -> Iterator[Geometry]:
    """All multisets of <= max_parts integers >= 1 whose product is n,
    as canonical tuples padded to max_parts with 1s."""

    def rec(remaining: int, max_factor: int, parts: Tuple[int, ...]) -> Iterator[Tuple[int, ...]]:
        if len(parts) == max_parts:
            if remaining == 1:
                yield parts
            return
        for f in range(min(remaining, max_factor), 0, -1):
            if remaining % f == 0:
                yield from rec(remaining // f, f, parts + (f,))

    yield from rec(n, n, ())


def all_divisor_geometries(n: int, D: int) -> List[Geometry]:
    """All canonical cuboid geometries of n vertices with <= D dimensions,
    sorted descending (most elongated first)."""
    return sorted(set(factorizations(n, D)), reverse=True)


def enumerate_vertices(dims: Sequence[int]) -> Iterator[Tuple[int, ...]]:
    """All vertex coordinate tuples, in C (row-major, last dim fastest) order."""
    yield from itertools.product(*(range(a) for a in dims))


def _divisors(t: int, cap: Optional[int] = None) -> np.ndarray:
    """Divisors of t, optionally only those <= cap (a side can never exceed
    the longest torus dimension, so the enumeration caps there)."""
    hi = t if cap is None else min(t, cap)
    d = np.arange(1, hi + 1, dtype=np.int64)
    return d[t % d == 0]


# ---------------------------------------------------------------------------
# Brute-force validation torus.
# ---------------------------------------------------------------------------
@dataclass
class ExplicitTorus:
    """Small explicit torus used for brute-force validation in tests.

    Unlike the closed-form functions above, this builds vertex/edge sets
    explicitly, so that cut counting for *arbitrary* (non-cuboid) subsets can
    be cross-checked.  Multi-edges for length-2 dimensions are honoured.
    """

    dims: Tuple[int, ...]
    _edges: list = field(default_factory=list)

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        edges = []
        for v in enumerate_vertices(self.dims):
            for k, a in enumerate(self.dims):
                if a == 1:
                    continue
                w = list(v)
                w[k] = (v[k] + 1) % a
                w = tuple(w)
                edges.append((v, w))
                if a == 2 and v[k] == 0:
                    edges.append((v, w))  # double link
        # every undirected edge appended once per +1 step; for a>2 this counts
        # each ring edge exactly once, for a==2 the pair (0,1) gets two edges.
        if any(a == 2 for a in self.dims):
            # For a==2 dims: v[k]=0 appends (0->1) twice, v[k]=1 appends (1->0)
            # once == duplicate of (0,1). Filter: keep edges from v[k]<w[k] side.
            filt = []
            for (v, w) in edges:
                ks = [k for k in range(len(self.dims)) if v[k] != w[k]]
                k = ks[0]
                if self.dims[k] == 2 and v[k] != 0:
                    continue
                filt.append((v, w))
            edges = filt
        self._edges = edges

    @property
    def num_vertices(self) -> int:
        return volume(self.dims)

    @property
    def num_edges(self) -> int:
        return len(self._edges)

    def cut(self, subset: Iterable[Tuple[int, ...]]) -> int:
        s = set(subset)
        return sum(1 for (v, w) in self._edges if (v in s) != (w in s))

    def interior(self, subset: Iterable[Tuple[int, ...]]) -> int:
        s = set(subset)
        return sum(1 for (v, w) in self._edges if v in s and w in s)

    def cuboid_vertices(self, cuboid: Sequence[int]) -> List[Tuple[int, ...]]:
        c = tuple(cuboid) + (1,) * (len(self.dims) - len(tuple(cuboid)))
        # place cuboid at origin, side i along dim i (caller aligns sides)
        for side, a in zip(c, self.dims):
            if side > a:
                raise ValueError(f"{c} does not fit in {self.dims} as aligned")
        return list(itertools.product(*(range(s) for s in c)))
