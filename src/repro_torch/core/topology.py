"""Other network topologies (paper Section 5, "Application to other topologies").

* Hypercubes  — Harper's theorem (1964): isoperimetric sets are Hamming balls
  / subcubes; a Q_d hypercube is the torus [2]^d, so the torus machinery
  applies directly (with the double-link convention disabled: hypercube
  dimension-2 "rings" are single edges).
* HyperX      — Cartesian products of cliques K_{a_1} x ... x K_{a_D};
  Lindsey's theorem (1964) solves the edge-isoperimetric problem: take
  vertices of the product cliques in order of descending clique size.
* Dragonfly   — groups of K_16 x K_6 (Cray Aries) with weighted links;
  a weighted edge-isoperimetric formulation over the group graph.

Host-side closed forms: the port's copy of ``repro.core.topology``.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.network.geometry import canonical, volume


# ---------------------------------------------------------------------------
# Hypercube (Q_d): torus [2]^d with single edges.
# ---------------------------------------------------------------------------
def hypercube_cuboid_cut(d: int, subcube_dims: Sequence[int]) -> int:
    """Cut of a subcube of Q_d: each uncovered dimension contributes |S| edges."""
    s = tuple(subcube_dims) + (1,) * (d - len(tuple(subcube_dims)))
    if len(s) != d or any(x not in (1, 2) for x in s):
        raise ValueError(f"subcube dims must be 1 or 2 per dimension, got {s}")
    size = volume(s)
    return sum(size for x in s if x == 1)


def hypercube_harper_bound(d: int, t: int) -> int:
    """Exact minimum cut for |S| = t in Q_d (Harper 1964), computed by the
    subcube + greedy-completion characterization for t a sum of powers of 2:
    cut(t) = sum over binary decomposition. For t = 2^k it equals
    2^k * (d - k)."""
    if not 0 <= t <= 2 ** d:
        raise ValueError("t out of range")
    # Harper: the minimal cut is attained by taking vertices in the
    # subcube-greedy order; standard recursive formula:
    return _harper_rec(d, t)


def _harper_rec(d: int, t: int) -> int:
    if t == 0 or t == 2 ** d:
        return 0
    half = 2 ** (d - 1)
    if t <= half:
        return _harper_rec(d - 1, t) + t
    return _harper_rec(d - 1, t - half) + (2 ** d - t)


def hypercube_bisection(d: int) -> int:
    return 2 ** (d - 1)


# ---------------------------------------------------------------------------
# HyperX: Cartesian product of cliques.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HyperX:
    clique_sizes: Tuple[int, ...]  # a_1 >= a_2 >= ... (canonical)
    link_capacity: float = 1.0  # regular HyperX

    def __init__(self, clique_sizes: Sequence[int], link_capacity: float = 1.0):
        object.__setattr__(self, "clique_sizes", canonical(clique_sizes))
        object.__setattr__(self, "link_capacity", float(link_capacity))

    @property
    def num_vertices(self) -> int:
        return volume(self.clique_sizes)

    def cuboid_cut(self, sub: Sequence[int]) -> int:
        """Cut of a sub-product choosing s_i vertices from clique i.

        Each partially-covered clique dimension contributes, per line,
        s_i * (a_i - s_i) clique edges.
        """
        a = self.clique_sizes
        s = canonical(sub)
        s = s + (1,) * (len(a) - len(s))
        size = volume(s)
        best = None
        for perm in set(itertools.permutations(s)):
            if any(x > y for x, y in zip(perm, a)):
                continue
            cut = sum(
                (size // si) * si * (ai - si)  # lines * per-line cut
                for si, ai in zip(perm, a)
                if si != ai
            )
            best = cut if best is None else min(best, cut)
        if best is None:
            raise ValueError(f"{s} does not fit in HyperX {a}")
        return best

    def lindsey_optimal_cut(self, t: int) -> int:
        """Exact isoperimetric optimum (Lindsey 1964): take vertices of the
        product cliques in order of descending size (paper Section 5) — i.e.
        lexicographic order with the *largest* clique varying fastest, so
        whole copies of the biggest cliques are filled first.  The recursion
        therefore peels the smallest clique as the outermost coordinate."""
        a = tuple(sorted(self.clique_sizes))  # ascending: smallest outermost
        n = self.num_vertices
        if not 0 <= t <= n:
            raise ValueError("t out of range")
        if t in (0, n):
            return 0
        # cut(prefix of size t in lex order) computed recursively: let the
        # first coordinate (largest clique, size a1) split lex order into a1
        # consecutive blocks of size n/a1.
        def rec(sizes: Tuple[int, ...], t: int) -> int:
            if t == 0 or not sizes:
                return 0
            a1 = sizes[0]
            block = math.prod(sizes[1:]) if len(sizes) > 1 else 1
            q, rem = divmod(t, block)
            # q fully-chosen levels of the outermost (smallest) clique, one
            # partially-chosen level of size rem, u fully-unchosen levels.
            u = a1 - q - (1 if rem else 0)
            # dim-1 clique edges join equal suffixes across levels:
            cut = q * block * u  # full levels <-> fully-unchosen levels
            if rem:
                cut += q * (block - rem)  # full levels <-> partial level's unchosen part
                cut += rem * u  # partial level's chosen part <-> unchosen levels
                cut += rec(sizes[1:], rem)  # edges inside the partial level
            return cut

        return rec(a, t)

    def bisection_links(self) -> int:
        return self.lindsey_optimal_cut(self.num_vertices // 2)

    def best_subproduct(self, t: int) -> Optional[Tuple[Tuple[int, ...], int]]:
        """Minimum-cut sub-product of size t (allocation-friendly partitions)."""
        from repro_torch.network.geometry import factorizations

        best = None
        for s in set(factorizations(t, len(self.clique_sizes))):
            try:
                cut = self.cuboid_cut(s)
            except ValueError:
                continue
            if best is None or cut < best[1]:
                best = (s, cut)
        return best


# ---------------------------------------------------------------------------
# Dragonfly (Cray Aries): weighted K_16 x K_6 groups.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DragonflyGroup:
    """One Aries group: K_16 x K_6 with K_6 links 3x the K_16 capacity."""

    a: int = 16
    b: int = 6
    w_a: float = 1.0
    w_b: float = 3.0

    @property
    def num_routers(self) -> int:
        return self.a * self.b

    def weighted_cut(self, sa: int, sb: int) -> float:
        """Weighted cut of a sub-product of sa x sb routers."""
        if not (0 < sa <= self.a and 0 < sb <= self.b):
            raise ValueError("sub-product out of range")
        size = sa * sb
        cut = 0.0
        if sa < self.a:
            cut += (size / sa) * sa * (self.a - sa) * self.w_a
        if sb < self.b:
            cut += (size / sb) * sb * (self.b - sb) * self.w_b
        return cut

    def best_subgroup(self, t: int) -> Optional[Tuple[Tuple[int, int], float]]:
        best = None
        for sa in range(1, self.a + 1):
            if t % sa:
                continue
            sb = t // sa
            if sb > self.b:
                continue
            cut = self.weighted_cut(sa, sb)
            if best is None or cut < best[1]:
                best = ((sa, sb), cut)
        return best
