"""Edge-isoperimetric analysis of torus graphs (port of the torus branches
of ``repro.network.isoperimetry``, paper Section 3).

* :func:`cut_table` — every cuboid geometry of a volume that fits a torus
  with its exact minimum cut: the host enumerates every aligned side
  assignment (divisor meshgrid), :func:`repro_torch.network.backend.
  cut_scores` evaluates the closed-form cut of each on ``device`` in
  int64, and the host groups them by canonical geometry.
* The Bollobás–Leader bound, Theorem 3.1 and Lemma 3.2; optimal and worst
  cuboids with a Theorem 3.1 certificate; small-set expansion.
* :func:`bisection_table` / :func:`ranked_geometries` — internal bisection
  of every same-volume geometry (node-level with ``unit_node_dims``), the
  allocation policies' ranking.
* The partition advisor, :func:`advise_partition` /
  :func:`advise_policy_table`: a policy's geometry against the optimum,
  the predicted pairing speedup and, with ``simulate=True``, both node
  tori drained by :func:`repro_torch.network.netsim.simulate_traffic` on
  ``device``.

On a :class:`~repro_torch.network.fabric.HyperXFabric` the same entry
points rank aligned boxes by the Hamming cut (scored on ``device`` in
int64, :func:`repro_torch.network.backend.hamming_cut_scores`), certify
with the Lindsey bound (:mod:`repro_torch.network.hamming`), and the
advisor's contention benchmark is the box's all-to-all.

Every function that reaches a pass takes ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network import hamming
from repro_torch.network.backend import cut_scores, hamming_cut_scores
from repro_torch.network.fabric import HyperXFabric
from repro_torch.network.geometry import (
    Geometry,
    _divisors,
    canonical,
    cuboid_cut,
    degree,
    theorem31_bound,
    volume,
)

__all__ = [
    "BisectionTable",
    "CuboidOptimum",
    "CutTable",
    "PartitionAdvice",
    "advise_partition",
    "advise_policy_table",
    "best_bisection_geometry",
    "bisection_of_geometry",
    "bisection_table",
    "bollobas_leader_bound",
    "cut_table",
    "fitting_geometries",
    "is_isoperimetrically_optimal",
    "lemma32_cut",
    "optimal_cuboid",
    "ranked_geometries",
    "scaled_node_dims",
    "small_set_expansion",
    "theorem31_bound",
    "worst_bisection_geometry",
    "worst_cuboid",
]


def _dims_of(torus_or_dims) -> Geometry:
    """Canonical dims of a ``Torus``/``TorusFabric``-like object or a tuple.
    A :class:`HyperXFabric` has clique, not ring, lines: the public entry
    points dispatch on it before reaching here."""
    if isinstance(torus_or_dims, HyperXFabric):
        raise TypeError(
            "HyperXFabric reached a torus-only code path; use the fabric-"
            "dispatching entry points (cut_table, optimal_cuboid, "
            "bisection_table, advise_partition, ...)"
        )
    if hasattr(torus_or_dims, "link_multiplicity"):  # another package's HyperX fabric
        raise TypeError(
            f"{type(torus_or_dims).__module__}.{type(torus_or_dims).__name__} is not a "
            "repro_torch HyperXFabric"
        )
    return canonical(getattr(torus_or_dims, "dims", torus_or_dims))


def _aligned_assignments(a: Geometry, t: int) -> np.ndarray:
    """All aligned side assignments of volume t into torus dims ``a``.

    Row k is ``(s_1, ..., s_D)`` with ``s_i | t``, ``s_i <= a_i`` and
    ``prod s_i == t`` — every feasible embedding of every fitting cuboid
    geometry, built dimension by dimension as a pruned divisor meshgrid
    (each step crosses the surviving partial assignments with the divisor
    list, keeping rows whose remaining volume divides out and still fits
    in the remaining dimensions).  Empty (shape (0, D)) when nothing fits.
    """
    D = len(a)
    divs = _divisors(t, cap=max(a, default=0))
    suffix = [1] * (D + 1)  # suffix[i] = prod(a[i:])
    for i in range(D - 1, -1, -1):
        suffix[i] = suffix[i + 1] * a[i]
    rows = np.zeros((1, 0), dtype=np.int64)
    rem = np.array([t], dtype=np.int64)
    for i, ai in enumerate(a):
        cand = divs[divs <= ai]
        ok = (rem[:, None] % cand[None, :]) == 0
        nrem = rem[:, None] // cand[None, :]
        ok &= nrem <= suffix[i + 1]
        r, c = np.nonzero(ok)
        rows = np.concatenate([rows[r], cand[c][:, None]], axis=1)
        rem = nrem[r, c]
    return rows[rem == 1]


@dataclass(frozen=True)
class CutTable:
    """Every canonical cuboid geometry of volume ``t`` fitting ``dims``,
    with its exact minimum cut (links, double-link convention).

    ``geometries`` is a (G, D) int array of canonical (sorted-descending)
    rows in ascending lexicographic order; ``cuts`` the matching (G,)
    minimum cut per geometry (minimised over all feasible embeddings).
    """

    dims: Geometry
    t: int
    geometries: np.ndarray
    cuts: np.ndarray

    def __len__(self) -> int:
        return len(self.geometries)

    def geometry(self, i: int) -> Geometry:
        """The i-th canonical geometry as a plain tuple."""
        return tuple(int(x) for x in self.geometries[i])

    def items(self) -> List[Tuple[Geometry, int]]:
        """(geometry, cut) pairs in the table's lexicographic row order."""
        return [(self.geometry(i), int(self.cuts[i])) for i in range(len(self))]

    def min_cut_geometry(self) -> Tuple[Geometry, int]:
        """Lexicographically-smallest geometry attaining the minimum cut."""
        i = int(np.nonzero(self.cuts == self.cuts.min())[0][0])
        return self.geometry(i), int(self.cuts[i])

    def max_cut_geometry(self) -> Tuple[Geometry, int]:
        """Lexicographically-largest geometry attaining the maximum cut."""
        i = int(np.nonzero(self.cuts == self.cuts.max())[0][-1])
        return self.geometry(i), int(self.cuts[i])


def cut_table(torus_or_dims, t: int, device: DeviceLike = "cuda") -> CutTable:
    """Exact minimum cuts of every cuboid geometry of volume ``t`` in a
    torus (a dims tuple or any object with ``.dims``): a side ``s``
    embedded in torus dimension ``a`` contributes ``0`` if ``s == a`` else
    ``2 t / s``.  On a :class:`HyperXFabric` the same enumeration scores
    the Hamming aligned-box cut ``t * sum_k K_k (S_k - c_k)`` (cuts
    decrease with side).  The cuts are scored on ``device``; the table
    equals the JAX package's ``cut_table`` in int64.

    >>> cut_table(HyperXFabric((4, 4), link_bw=1.0), 4, device="cpu").items()
    [((2, 2), 16), ((4, 1), 12)]
    """
    resolve_device(device)
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    if isinstance(torus_or_dims, HyperXFabric):
        a = torus_or_dims.dims
    else:
        a = _dims_of(torus_or_dims)
    S = _aligned_assignments(a, t)
    if S.shape[0] == 0:
        return CutTable(a, t, S.reshape(0, len(a)), np.zeros(0, dtype=np.int64))
    av = np.array(a, dtype=np.int64)
    if isinstance(torus_or_dims, HyperXFabric):
        cuts = hamming_cut_scores(a, torus_or_dims.link_multiplicity, S, t, device=device)
    else:
        cuts = cut_scores(a, S, t, device=device)
    G = -np.sort(-S, axis=1)  # canonical (descending) rows
    # Group by geometry via a positional integer key (base max(a)+1): a 1-D
    # unique on int64 keys, with the ascending-lexicographic row order of
    # np.unique(axis=0).
    base = int(av.max()) + 1
    key = G[:, 0].copy()
    for j in range(1, G.shape[1]):
        key = key * base + G[:, j]
    _, index, inv = np.unique(key, return_index=True, return_inverse=True)
    uniq = G[index]
    best = np.full(len(index), np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(best, inv.ravel(), cuts)
    return CutTable(a, t, uniq, best)


def fitting_geometries(torus_or_dims, units: int, device: DeviceLike = "cuda") -> np.ndarray:
    """All canonical cuboid geometries of ``units`` vertices that fit, as a
    (G, D) int array in ascending lexicographic row order."""
    return cut_table(torus_or_dims, units, device=device).geometries


# ---------------------------------------------------------------------------
# Bounds and constructions (paper Theorems 2.1/3.1, Lemma 3.2).
# ---------------------------------------------------------------------------
def bollobas_leader_bound(n: int, D: int, t: int) -> float:
    """Theorem 2.1: lower bound on |E(S, S̄)| for |S| = t in the cubic torus [n]^D."""
    if t < 0 or t > n**D // 2:
        raise ValueError("t must satisfy 0 <= t <= |V|/2")
    if t == 0:
        return 0.0
    best = math.inf
    for r in range(D):
        val = 2.0 * (D - r) * n ** (r / (D - r)) * t ** ((D - r - 1) / (D - r))
        best = min(best, val)
    return best


def lemma32_cut(dims: Sequence[int], t: int, r: int) -> Optional[Tuple[Geometry, int]]:
    """Lemma 3.2: the explicit cuboid S_r and its exact cut, if it exists.

    S_r fully covers the r smallest dimensions and is a cube of side
    s = (t / k)^(1/(D-r)) in the remaining D-r dimensions, where k is the
    product of the r smallest dims.  ``None`` when s is not an integer or
    S_r does not fit.
    """
    a = canonical(dims)
    D = len(a)
    if not 0 <= r < D:
        raise ValueError(f"r must be in [0, {D}), got {r}")
    k = math.prod(a[D - r:]) if r > 0 else 1
    if t % k != 0:
        return None
    q = t // k
    s = round(q ** (1.0 / (D - r)))
    if s ** (D - r) != q:
        return None
    if s > min(a[: D - r]):
        return None  # the cube side must fit in each uncovered dimension
    geometry = canonical((s,) * (D - r) + tuple(a[D - r:]))
    return geometry, cuboid_cut(a, geometry)


@dataclass(frozen=True)
class CuboidOptimum:
    """A min- or max-cut cuboid with its Theorem 3.1 lower bound; ``tight``
    certifies that the cut meets the bound exactly."""

    geometry: Geometry
    cut: int
    bound: float

    @property
    def tight(self) -> bool:
        """Whether the cut achieves the Theorem 3.1 bound (certificate)."""
        return math.isclose(self.cut, self.bound, rel_tol=1e-9)


def _subset_bound(a: Geometry, n: int, t: int) -> float:
    """Theorem 3.1 bound on any size-t subset's cut, via complement symmetry
    for t > n/2 (cut(S) == cut(S̄))."""
    return theorem31_bound(a, min(t, n - t))


def _any_subset_bound(torus_or_dims, n: int, t: int) -> float:
    """Lower bound on any size-t subset's cut: Theorem 3.1 on a torus, the
    Lindsey/edge-identity bound on a Hamming graph (exact for uniform link
    multiplicity), both with complement symmetry."""
    if isinstance(torus_or_dims, HyperXFabric):
        return float(hamming.hamming_subset_bound(torus_or_dims.dims, t, torus_or_dims.link_multiplicity))
    return _subset_bound(_dims_of(torus_or_dims), n, t)


def _extreme_cuboid(torus_or_dims, t: int, device: DeviceLike, worst: bool) -> Optional[CuboidOptimum]:
    a = torus_or_dims if isinstance(torus_or_dims, HyperXFabric) else _dims_of(torus_or_dims)
    n = volume(a.dims if isinstance(a, HyperXFabric) else a)
    if t <= 0 or t > n:
        raise ValueError(f"t must be in (0, {n}], got {t}")
    tbl = cut_table(a, t, device=device)
    if len(tbl) == 0:
        return None
    geom, cut = tbl.max_cut_geometry() if worst else tbl.min_cut_geometry()
    return CuboidOptimum(geom, cut, _any_subset_bound(a, n, t))


def optimal_cuboid(torus_or_dims, t: int, device: DeviceLike = "cuda") -> Optional[CuboidOptimum]:
    """Exact minimum-cut cuboid of size t inside the torus (Lemma 3.3
    optimum); ``None`` when no cuboid of exactly ``t`` vertices fits,
    ``ValueError`` for t outside (0, n].  Ties break toward the
    lexicographically-smallest canonical geometry.  On a
    :class:`HyperXFabric` the certificate is the Lindsey bound (exact
    under uniform link multiplicity).

    >>> opt = optimal_cuboid((4, 4, 2), 8, device="cpu")
    >>> opt.geometry, opt.cut, opt.tight
    ((2, 2, 2), 16, True)
    """
    return _extreme_cuboid(torus_or_dims, t, device, worst=False)


def worst_cuboid(torus_or_dims, t: int, device: DeviceLike = "cuda") -> Optional[CuboidOptimum]:
    """Maximum-cut cuboid of size t — the adversarial partition geometry
    (validation and certificate as :func:`optimal_cuboid`)."""
    return _extreme_cuboid(torus_or_dims, t, device, worst=True)


def small_set_expansion(torus_or_dims, t: int, device: DeviceLike = "cuda") -> float:
    """h_t(G) over cuboid witnesses: min_{|A|<=t} cut(A) / (interior(A)+cut(A)),
    from the per-size minimum cuts by the regularity identity (Eq. 1)."""
    a = _dims_of(torus_or_dims)
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    k = degree(a)
    best = math.inf
    for size in range(1, t + 1):
        tbl = cut_table(a, size, device=device)
        if len(tbl) == 0:
            continue
        cut = int(tbl.cuts.min())
        denom = k * size + cut
        if denom == 0:
            continue
        best = min(best, 2.0 * cut / denom)
    return best


# ---------------------------------------------------------------------------
# Internal bisection of same-volume geometries (the allocator's ranking).
# ---------------------------------------------------------------------------
def bisection_of_geometry(dims: Sequence[int], device: DeviceLike = "cuda") -> int:
    """Internal bisection (links) of a fully-wrapped torus partition with the
    given dims, equal to :func:`repro_torch.network.geometry.bisection_links`."""
    a = canonical(dims)
    n = volume(a)
    if n == 1:
        return 0
    L = a[0]
    if L % 2 == 0:
        return 2 * n // L
    if L == 1:
        return 0
    tbl = cut_table(a, n // 2, device=device)
    if len(tbl) == 0:
        return math.ceil(theorem31_bound(a, n // 2))
    return int(tbl.cuts.min())


def scaled_node_dims(
    geometry: Sequence[int], unit_node_dims: Optional[Sequence[int]] = None
) -> Geometry:
    """Node-level torus dims of a partition: each allocation-unit dimension
    scales the node torus; extra unit dims (e.g. the Blue Gene/Q internal
    length-2 fifth dimension) are appended.  Identity when
    ``unit_node_dims`` is None; a unit with fewer dims than the geometry
    is an error."""
    g = canonical(geometry)
    if unit_node_dims is None:
        return g
    unit = tuple(int(u) for u in unit_node_dims)
    if len(unit) < len(g):
        raise ValueError(
            f"unit_node_dims {unit} has fewer dims than geometry {g}; every "
            f"allocation-unit dimension needs a node-scale factor"
        )
    scaled = tuple(gi * u for gi, u in zip(g, unit[: len(g)]))
    return canonical(scaled + unit[len(g):])


@dataclass(frozen=True)
class BisectionTable:
    """Internal bisection of every cuboid geometry of one volume fitting a
    machine torus.  ``geometries`` is the (G, D) canonical row array of
    :func:`fitting_geometries`; ``bisections`` each geometry's internal
    bisection as its own fully-wrapped torus (node level when built with
    ``unit_node_dims``)."""

    dims: Geometry
    units: int
    geometries: np.ndarray
    bisections: np.ndarray
    unit_node_dims: Optional[Geometry] = None

    def __len__(self) -> int:
        return len(self.geometries)

    def _geometry(self, i: int) -> Geometry:
        return tuple(int(x) for x in self.geometries[i])

    def best(self) -> Tuple[Geometry, int]:
        """Max-bisection geometry (lexicographically smallest on ties)."""
        i = int(np.nonzero(self.bisections == self.bisections.max())[0][0])
        return self._geometry(i), int(self.bisections[i])

    def worst(self) -> Tuple[Geometry, int]:
        """Min-bisection geometry (lexicographically largest on ties)."""
        i = int(np.nonzero(self.bisections == self.bisections.min())[0][-1])
        return self._geometry(i), int(self.bisections[i])

    def bisection_of(self, geometry: Sequence[int]) -> int:
        """Bisection of one geometry in the table (unit dims normalised
        away); ValueError if absent."""
        g = tuple(x for x in canonical(geometry) if x > 1)
        if len(g) > len(self.dims):
            raise ValueError(
                f"geometry {tuple(geometry)} is not a fitting {self.units}-unit "
                f"cuboid of {self.dims}"
            )
        row = np.array(g + (1,) * (len(self.dims) - len(g)), dtype=np.int64)
        hits = np.nonzero((self.geometries == row[None, :]).all(axis=1))[0]
        if len(hits) == 0:
            raise ValueError(
                f"geometry {tuple(geometry)} is not a fitting {self.units}-unit "
                f"cuboid of {self.dims}"
            )
        return int(self.bisections[hits[0]])

    def ranked(self) -> List[Tuple[Geometry, int]]:
        """(geometry, bisection) pairs, best bisection first, ties toward
        the lexicographically-smallest geometry."""
        pairs = [(self._geometry(i), int(self.bisections[i])) for i in range(len(self))]
        pairs.sort(key=lambda p: (-p[1], p[0]))
        return pairs


def bisection_table(
    torus_or_dims,
    units: int,
    unit_node_dims: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> BisectionTable:
    """Internal bisections of every ``units``-sized geometry: closed-form
    ``2N/L`` for an even longest (node) dimension, the exact cuboid search
    on ``device`` for an odd one.  Raises ``ValueError`` when no cuboid of
    that size fits.

    On a :class:`HyperXFabric` each box is its own Hamming graph
    (:meth:`HyperXFabric.sub_fabric`), ranked by its exact Lindsey
    half-set cut; ``unit_node_dims`` (the Blue Gene/Q node scaling) is
    rejected there.

    >>> bisection_table(HyperXFabric((16, 4), link_bw=1.0), 16, device="cpu").ranked()
    [((16, 1), 64), ((4, 4), 16), ((8, 2), 8)]
    """
    if isinstance(torus_or_dims, HyperXFabric):
        if unit_node_dims is not None:
            raise ValueError(
                "unit_node_dims is the BG/Q torus node-scaling convention; "
                "HyperX fabrics rank allocation-unit boxes directly"
            )
        fab = torus_or_dims
        geoms = cut_table(fab, units, device=device).geometries
        if geoms.shape[0] == 0:
            raise ValueError(f"no box of {units} units fits in H{fab.dims}")
        bis = np.array([fab.sub_fabric(tuple(int(x) for x in g)).bisection_links() for g in geoms], dtype=np.int64)
        return BisectionTable(fab.dims, units, geoms, bis, None)
    a = _dims_of(torus_or_dims)
    geoms = fitting_geometries(a, units, device=device)
    if geoms.shape[0] == 0:
        raise ValueError(f"no cuboid of {units} units fits in {a}")
    unit = None if unit_node_dims is None else tuple(int(u) for u in unit_node_dims)
    if unit is not None and len(unit) < len(a):
        raise ValueError(
            f"unit_node_dims {unit} has fewer dims than the machine {a}; every "
            f"allocation-unit dimension needs a node-scale factor"
        )
    if unit is None:
        node = geoms
        n_total = units
        extras_max = 0
    else:
        uvec = np.array(unit[: geoms.shape[1]], dtype=np.int64)
        node = geoms * uvec[None, :]
        extras = unit[geoms.shape[1]:]
        extras_max = max(extras, default=0)
        n_total = units * math.prod(unit)
    L = np.maximum(node.max(axis=1), extras_max)
    bis = np.zeros(len(geoms), dtype=np.int64)
    even = (L % 2 == 0) & (L > 1)
    bis[even] = 2 * n_total // L[even]
    odd = (~even) & (L > 1)
    for i in np.nonzero(odd)[0]:
        g = tuple(int(x) for x in geoms[i])
        bis[i] = bisection_of_geometry(g if unit is None else scaled_node_dims(g, unit), device=device)
    return BisectionTable(a, units, geoms, bis, unit)


def ranked_geometries(
    torus_or_dims,
    units: int,
    unit_node_dims: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> List[Tuple[Geometry, int]]:
    """All fitting geometries of a size as (geometry, bisection_links)
    pairs, best internal bisection first."""
    return bisection_table(torus_or_dims, units, unit_node_dims, device=device).ranked()


def best_bisection_geometry(
    torus_or_dims, units: int, unit_node_dims: Optional[Sequence[int]] = None, device: DeviceLike = "cuda"
) -> Tuple[Geometry, int]:
    """The fitting geometry with maximal internal bisection (links)."""
    return bisection_table(torus_or_dims, units, unit_node_dims, device=device).best()


def worst_bisection_geometry(
    torus_or_dims, units: int, unit_node_dims: Optional[Sequence[int]] = None, device: DeviceLike = "cuda"
) -> Tuple[Geometry, int]:
    """The fitting geometry with minimal internal bisection — the
    adversarial baseline of the avoidable-contention ratio."""
    return bisection_table(torus_or_dims, units, unit_node_dims, device=device).worst()


def is_isoperimetrically_optimal(
    torus_or_dims,
    geometry: Sequence[int],
    unit_node_dims: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> bool:
    """Theorem 3.1 optimality check: does this partition geometry attain the
    maximal internal bisection among all same-volume cuboids that fit?"""
    tbl = bisection_table(torus_or_dims, volume(geometry), unit_node_dims, device=device)
    return tbl.bisection_of(geometry) == tbl.best()[1]


# ---------------------------------------------------------------------------
# The partition advisor (paper Tables 4-6 as a decision aid).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PartitionAdvice:
    """Current-policy vs isoperimetric-optimal geometry for one job size.

    Bisections are in links (node level with ``unit_node_dims``);
    ``predicted_speedup`` is the pairing-benchmark time ratio
    current/optimal, ``simulated_speedup`` the flow-simulated makespan
    ratio with ``simulate=True``; ``bound`` is the Theorem 3.1 floor on
    the optimal geometry's bisection cut.
    """

    units: int
    current_geometry: Geometry
    current_bisection: int
    optimal_geometry: Geometry
    optimal_bisection: int
    bound: float
    predicted_speedup: float
    simulated_speedup: Optional[float] = None

    @property
    def bisection_efficiency(self) -> float:
        """current / optimal internal bisection (1.0 when already optimal)."""
        if self.optimal_bisection == 0:
            return 1.0
        return self.current_bisection / self.optimal_bisection

    @property
    def is_current_optimal(self) -> bool:
        """Whether the current geometry already attains the optimum."""
        return self.current_bisection == self.optimal_bisection

    @property
    def certified(self) -> bool:
        """Whether Theorem 3.1 certifies the optimum's bisection exactly."""
        return math.isclose(self.optimal_bisection, self.bound, rel_tol=1e-9)


def advise_partition(
    torus_or_dims,
    units: int,
    current_geometry: Optional[Sequence[int]] = None,
    *,
    unit_node_dims: Optional[Sequence[int]] = None,
    simulate: bool = False,
    device: DeviceLike = "cuda",
) -> PartitionAdvice:
    """Advise one job size: current (or worst, when None) vs optimal geometry.

    The predicted speedup is the static pairing-benchmark ratio on the
    node-level dims; ``simulate=True`` also drains both geometries'
    pairing benchmark on ``device`` and reports the makespan ratio.

    >>> adv = advise_partition((4, 4, 3, 2), 4, (4, 1, 1, 1),
    ...                        unit_node_dims=(4, 4, 4, 4, 2), device="cpu")
    >>> adv.optimal_geometry, adv.current_bisection, adv.optimal_bisection
    ((2, 2, 1, 1), 256, 512)
    >>> round(adv.predicted_speedup, 2), adv.is_current_optimal, adv.certified
    (2.0, False, True)

    On a :class:`HyperXFabric` the contention benchmark is all-to-all
    inside the box (pairing never contends across diameter-1 dimensions)
    and the certificate is the Lindsey bound on the optimum's half-set.

    >>> adv = advise_partition(HyperXFabric((16, 4), link_bw=1.0), 16, (4, 4), device="cpu")
    >>> adv.optimal_geometry, adv.current_bisection, adv.optimal_bisection
    ((16, 1), 16, 64)
    >>> adv.predicted_speedup, adv.is_current_optimal, adv.certified
    (4.0, False, True)
    """
    from repro_torch.network.routing import pairing_speedup

    if isinstance(torus_or_dims, HyperXFabric):
        return _advise_hyperx(torus_or_dims, units, current_geometry, unit_node_dims=unit_node_dims,
                              simulate=simulate, device=device)
    a = _dims_of(torus_or_dims)
    tbl = bisection_table(a, units, unit_node_dims, device=device)
    opt_geom, opt_bis = tbl.best()
    if current_geometry is None:
        cur_geom, cur_bis = tbl.worst()
    else:
        cur_geom = canonical(tuple(current_geometry) + (1,) * (len(a) - len(tuple(current_geometry))))
        if volume(cur_geom) != units:
            raise ValueError(
                f"current geometry {cur_geom} has volume {volume(cur_geom)}, expected {units}"
            )
        cur_bis = tbl.bisection_of(cur_geom)
    nd_cur = scaled_node_dims(cur_geom, unit_node_dims)
    nd_opt = scaled_node_dims(opt_geom, unit_node_dims)
    predicted = pairing_speedup(nd_cur, nd_opt)
    simulated: Optional[float] = None
    if simulate:
        from repro_torch.network.netsim import simulate_traffic
        from repro_torch.network.patterns import bisection_pairing

        t_cur = simulate_traffic(nd_cur, bisection_pairing(nd_cur), device=device).makespan
        t_opt = simulate_traffic(nd_opt, bisection_pairing(nd_opt), device=device).makespan
        simulated = t_cur / t_opt
    n_nodes = volume(nd_opt)
    return PartitionAdvice(
        units=units,
        current_geometry=cur_geom,
        current_bisection=cur_bis,
        optimal_geometry=opt_geom,
        optimal_bisection=opt_bis,
        bound=theorem31_bound(nd_opt, n_nodes // 2),
        predicted_speedup=predicted,
        simulated_speedup=simulated,
    )


def _advise_hyperx(
    fab: HyperXFabric,
    units: int,
    current_geometry: Optional[Sequence[int]],
    *,
    unit_node_dims: Optional[Sequence[int]],
    simulate: bool,
    device: DeviceLike,
) -> PartitionAdvice:
    """HyperX body of :func:`advise_partition`: rank boxes by internal
    Hamming bisection, predict the all-to-all contention ratio with the
    closed form, certify with the Lindsey half-set bound."""
    from repro_torch.network.routing import hyperx_all_to_all_max_load

    tbl = bisection_table(fab, units, unit_node_dims, device=device)  # rejects node scaling
    opt_geom, opt_bis = tbl.best()
    if current_geometry is None:
        cur_geom, cur_bis = tbl.worst()
    else:
        cur_geom = canonical(tuple(current_geometry) + (1,) * (len(fab.dims) - len(tuple(current_geometry))))
        if volume(cur_geom) != units:
            raise ValueError(
                f"current geometry {cur_geom} has volume {volume(cur_geom)}, expected {units}"
            )
        cur_bis = tbl.bisection_of(cur_geom)
    sub_cur = fab.sub_fabric(cur_geom)
    sub_opt = fab.sub_fabric(opt_geom)
    load_cur = hyperx_all_to_all_max_load(sub_cur)
    load_opt = hyperx_all_to_all_max_load(sub_opt)
    predicted = load_cur / load_opt if load_opt > 0.0 else 1.0
    simulated: Optional[float] = None
    if simulate:
        from repro_torch.network.netsim import simulate_fabric_traffic
        from repro_torch.network.patterns import all_to_all

        t_cur = simulate_fabric_traffic(sub_cur, all_to_all(sub_cur.dims), device=device).makespan
        t_opt = simulate_fabric_traffic(sub_opt, all_to_all(sub_opt.dims), device=device).makespan
        simulated = t_cur / t_opt if t_opt > 0.0 else 1.0
    return PartitionAdvice(
        units=units,
        current_geometry=cur_geom,
        current_bisection=cur_bis,
        optimal_geometry=opt_geom,
        optimal_bisection=opt_bis,
        bound=float(hamming.hamming_subset_bound(sub_opt.dims, units // 2, sub_opt.link_multiplicity)),
        predicted_speedup=predicted,
        simulated_speedup=simulated,
    )


def advise_policy_table(
    torus_or_dims,
    policy_table: Mapping[int, Sequence[int]],
    *,
    unit_node_dims: Optional[Sequence[int]] = None,
    simulate: bool = False,
    sizes: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> List[PartitionAdvice]:
    """Advise every size of an allocation policy's admissible geometry table
    (e.g. Mira's scheduler partition list): one :class:`PartitionAdvice`
    per size, ascending."""
    chosen = sorted(policy_table) if sizes is None else [s for s in sizes if s in policy_table]
    return [
        advise_partition(
            torus_or_dims,
            size,
            policy_table[size],
            unit_node_dims=unit_node_dims,
            simulate=simulate,
            device=device,
        )
        for size in chosen
    ]
