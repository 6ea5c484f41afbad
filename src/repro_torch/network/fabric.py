"""Fabric models (the port's copy of ``repro.network.fabric``): one class
for Blue Gene/Q- and TPU-style tori, and the HyperX fabric.

* Blue Gene/Q: a partition always keeps its wrap-around links and a
  dimension of length 2 has two parallel links — ``TorusFabric.bgq``.
* Single-link tori with per-dimension wrap flags — ``TorusFabric.tpu``.
* HyperX (:class:`HyperXFabric`): a clique per dimension, the Hamming
  graph, with optional trunked links per dimension.

``link_bw`` (per link per direction) is a required argument here: the
port carries no default link rate.  Slice planning (the paper's technique
at the job level: :func:`slice_fabric`, :func:`ranked_slice_geometries`,
:func:`best_slice_geometry`, :func:`worst_slice_geometry`) takes a torus
pod; a HyperX pod is planned through its own sub-boxes
(:meth:`HyperXFabric.sub_fabric`).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.network import geometry, hamming
from repro_torch.network.geometry import Geometry, canonical, volume

__all__ = [
    "Fabric",
    "HyperXFabric",
    "LinkTable",
    "Torus",
    "TorusFabric",
    "best_slice_geometry",
    "ranked_slice_geometries",
    "slice_fabric",
    "worst_slice_geometry",
]


@dataclass(frozen=True)
class LinkTable:
    """Explicit directed-link incidence of a fabric.

    Parallel arrays: ``link[i]`` is the flat link id (an index into the
    fabric's dense id space of ``n_slots`` slots — some may be unused,
    e.g. length-1 torus dimensions), ``src[i]``/``dst[i]`` the endpoint
    cells as flat C-order indices, and ``capacity[i]`` the link bandwidth
    (parallel physical links fold into capacity).
    """

    link: np.ndarray  # (L,) int64 flat link ids, unique
    src: np.ndarray  # (L,) int64 source cell (flat C-order)
    dst: np.ndarray  # (L,) int64 destination cell (flat C-order)
    capacity: np.ndarray  # (L,) float
    n_slots: int  # size of the dense link-id space

    def __len__(self) -> int:
        return int(self.link.shape[0])

    def dense_capacities(self) -> np.ndarray:
        """Per-slot capacities, zero on unused slots."""
        cap = np.zeros(self.n_slots, dtype=np.float64)
        cap[self.link] = self.capacity
        return cap

    def neighbors_of(self, cell: int) -> np.ndarray:
        """Sorted unique flat cell indices one link away from ``cell``."""
        return np.unique(self.dst[self.src == int(cell)])


class Fabric(abc.ABC):
    """Abstract interconnect fabric: cells joined by capacitated links, on
    a dense cell grid of per-dimension sizes ``dims``."""

    dims: Tuple[int, ...]
    link_bw: float

    @property
    def num_cells(self) -> int:
        """Number of cells (allocation units) in the fabric."""
        return volume(self.dims)

    @property
    def dim_sizes(self) -> Tuple[int, ...]:
        """Per-dimension cell counts (the placement grid's shape)."""
        return tuple(self.dims)

    @abc.abstractmethod
    def links(self) -> LinkTable:
        """The explicit ``(link, src_cell, dst_cell, capacity)`` table."""

    @abc.abstractmethod
    def bisection_links(self) -> int:
        """Internal bisection of the fabric in (unit-capacity) links."""

    def neighbors(self, cell: int) -> np.ndarray:
        """Flat cell indices adjacent to ``cell`` (sorted, unique)."""
        return self.links().neighbors_of(cell)


@dataclass(frozen=True)
class TorusFabric(Fabric):
    """A physical torus (or mesh) fabric: a machine or a partition.

    ``dims`` are cell counts per dimension, ``wrap`` flags the wrap-around
    link per dimension, ``link_bw`` is the rate per link per direction and
    ``double_link_on_2`` selects the Blue Gene/Q convention (two parallel
    links on a length-2 dimension) over a single link.

    >>> bgq = TorusFabric.bgq((4, 4, 4), link_bw=1.0)
    >>> bgq.num_chips, bgq.bisection_links()
    (64, 32)
    >>> chain = TorusFabric.tpu((4, 2), wrap=(True, False), link_bw=1.0)
    >>> chain.bisection_links()  # unwrapped dim is cut once, not twice
    4
    """

    dims: Tuple[int, ...]
    wrap: Tuple[bool, ...]  # wrap-around link present per dimension
    link_bw: float  # per link per direction
    double_link_on_2: bool = False  # Blue Gene/Q: True

    def __post_init__(self):
        if len(self.dims) != len(self.wrap):
            raise ValueError("dims and wrap must have equal length")

    @classmethod
    def bgq(cls, dims: Sequence[int], link_bw: float) -> "TorusFabric":
        """Blue Gene/Q convention: fully wrapped, double links on a==2."""
        d = tuple(int(a) for a in dims)
        return cls(d, (True,) * len(d), link_bw, double_link_on_2=True)

    @classmethod
    def tpu(
        cls, dims: Sequence[int], wrap: Optional[Sequence[bool]] = None, *, link_bw: float
    ) -> "TorusFabric":
        """Explicit wrap flags, single links on a==2."""
        d = tuple(int(a) for a in dims)
        w = tuple(bool(x) for x in wrap) if wrap is not None else (True,) * len(d)
        return cls(d, w, link_bw, double_link_on_2=False)

    @property
    def num_chips(self) -> int:
        """Number of allocation units (chips / midplanes) in the fabric."""
        return volume(self.dims)

    @property
    def num_vertices(self) -> int:
        """Alias of :attr:`num_chips` for graph-flavoured callers."""
        return self.num_chips

    @property
    def is_fully_wrapped(self) -> bool:
        """Whether every non-trivial dimension keeps its wrap-around link."""
        return all(self.wrap[k] for k, a in enumerate(self.dims) if a > 1)

    def links_across_dim(self, k: int) -> int:
        """Links crossing a perpendicular plane of dimension k (per plane)."""
        return self.num_chips // self.dims[k]

    def bisection_links(self) -> int:
        """Internal bisection in links: the exact edge-isoperimetric value
        for fully-wrapped double-link fabrics, else the min-over-dimensions
        halving cut (a wrapped dimension cut in two places, a chain in
        one; a wrapped double-link length-2 dimension contributes 2)."""
        if self.is_fully_wrapped and self.double_link_on_2:
            return geometry.bisection_links(self.dims)
        best = None
        for k, a in enumerate(self.dims):
            if a == 1:
                continue
            planes = 2 if (self.wrap[k] and a > 2) else 1
            if a == 2 and self.wrap[k] and self.double_link_on_2:
                planes = 2
            cut = planes * self.links_across_dim(k)
            best = cut if best is None else min(best, cut)
        return 0 if best is None else best

    def bisection_bandwidth(self) -> float:
        """Rate across the bisection, both directions of each link."""
        return 2.0 * self.bisection_links() * self.link_bw

    def contains_cuboid(self, cuboid: Sequence[int]) -> bool:
        """Whether the cuboid geometry fits this fabric (up to rotation)."""
        return geometry.contains_cuboid(self.dims, cuboid)

    def sub_cuboids(self, size: int) -> Iterator[Geometry]:
        """All canonical cuboid geometries of ``size`` units that fit."""
        return geometry.sub_cuboids(self.dims, size)

    def links(self) -> LinkTable:
        """Directed ring links, ids matching the flattened ``(D, 2, *dims)``
        load-tensor layout of ``route_dor`` (slot ``(k * 2 + direction) *
        N + cell``); a length-2 dimension's two parallel links (BG/Q) fold
        into doubled capacity.  ``wrap`` affects bisection accounting, not
        the routed incidence."""
        dims = self.dims
        n = self.num_cells
        d = len(dims)
        cells = np.arange(n, dtype=np.int64)
        coords = np.stack(np.unravel_index(cells, dims), axis=1) if d else cells[:, None]
        link, src, dst, cap = [], [], [], []
        for k, a in enumerate(dims):
            if a <= 1:
                continue
            c = 2.0 * self.link_bw if (a == 2 and self.double_link_on_2) else self.link_bw
            for direction, step in ((0, 1), (1, -1)):
                nb = coords.copy()
                nb[:, k] = (nb[:, k] + step) % a
                link.append((k * 2 + direction) * n + cells)
                src.append(cells)
                dst.append(np.ravel_multi_index(tuple(nb.T), dims))
                cap.append(np.full(n, c))
        empty = np.zeros(0, dtype=np.int64)
        return LinkTable(
            link=np.concatenate(link) if link else empty,
            src=np.concatenate(src) if src else empty.copy(),
            dst=np.concatenate(dst) if dst else empty.copy(),
            capacity=np.concatenate(cap) if cap else np.zeros(0),
            n_slots=2 * d * n,
        )


@dataclass(frozen=True)
class Torus:
    """A fully-wrapped D-dimensional torus graph (the paper's object),
    with Blue Gene/Q double-link edge counting."""

    dims: Geometry

    def __init__(self, dims: Iterable[int]):
        object.__setattr__(self, "dims", canonical(dims))

    @property
    def D(self) -> int:
        return len(self.dims)

    @property
    def num_vertices(self) -> int:
        return volume(self.dims)

    @property
    def degree(self) -> int:
        return geometry.degree(self.dims)

    @property
    def num_edges(self) -> int:
        return geometry.num_edges(self.dims)

    def fabric(self, link_bw: float) -> TorusFabric:
        """The equivalent bandwidth-aware fabric (BG/Q convention)."""
        return TorusFabric.bgq(self.dims, link_bw)

    def contains_cuboid(self, cuboid: Sequence[int]) -> bool:
        return geometry.contains_cuboid(self.dims, cuboid)

    def cuboid_cut(self, cuboid: Sequence[int]) -> int:
        return geometry.cuboid_cut(self.dims, cuboid)

    def cuboid_cut_aligned(self, sides: Sequence[int]) -> int:
        return geometry.cuboid_cut_aligned(self.dims, sides)

    def cuboid_interior(self, cuboid: Sequence[int]) -> int:
        return geometry.cuboid_interior(self.dims, cuboid)

    def sub_cuboids(self, size: int) -> Iterator[Geometry]:
        return geometry.sub_cuboids(self.dims, size)

    def bisection_links(self) -> int:
        return geometry.bisection_links(self.dims)


# ---------------------------------------------------------------------------
# HyperX: a clique per dimension (the Hamming graph H(S_1, ..., S_D)).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HyperXFabric(Fabric):
    """A HyperX fabric: per-dimension diameter-1 all-to-all wiring.

    Every cell connects directly to every other cell of each of its
    dimension lines (the Hamming graph), with an optional per-dimension
    link multiplicity ``K_k`` (trunked parallel links fold into
    capacity).  Cut structure is the opposite of a torus: covering a
    dimension removes its whole cut contribution, so elongated boxes have
    the largest internal bisection (:mod:`repro_torch.network.hamming`).
    ``link_bw`` (per single link per direction) is required.

    >>> hx = HyperXFabric((16, 4), link_bw=1.0)
    >>> hx.num_cells, hx.degree, hx.bisection_links()
    (64, 18, 64)
    >>> hx.sub_fabric((4, 4)).bisection_links()  # compact box: 4x worse
    16
    """

    dims: Tuple[int, ...]
    link_multiplicity: Optional[Tuple[int, ...]] = None  # K_k, default all 1
    link_bw: float = field(kw_only=True)

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(a) for a in self.dims))
        if any(a < 1 for a in self.dims):
            raise ValueError(f"dims must be >= 1, got {self.dims}")
        mult = self.link_multiplicity
        mult = (1,) * len(self.dims) if mult is None else tuple(int(k) for k in mult)
        if len(mult) != len(self.dims) or any(k < 1 for k in mult):
            raise ValueError(
                f"link_multiplicity {self.link_multiplicity} must be one "
                f"positive entry per dim of {self.dims}"
            )
        object.__setattr__(self, "link_multiplicity", mult)

    @property
    def num_chips(self) -> int:
        """Alias of :attr:`Fabric.num_cells` (fabric-API symmetry)."""
        return self.num_cells

    @property
    def num_vertices(self) -> int:
        """Alias of :attr:`Fabric.num_cells` for graph-flavoured callers."""
        return self.num_cells

    @property
    def degree(self) -> int:
        """Links per cell: ``sum_k K_k * (S_k - 1)``."""
        return hamming.hamming_degree(self.dims, self.link_multiplicity)

    def bisection_links(self) -> int:
        """Exact internal bisection: the Lindsey lex half-set's cut
        (:func:`repro_torch.network.hamming.hamming_bisection_links`)."""
        return hamming.hamming_bisection_links(self.dims, self.link_multiplicity)

    def bisection_bandwidth(self) -> float:
        """Rate across the bisection, both directions of each link."""
        return 2.0 * self.bisection_links() * self.link_bw

    def contains_cuboid(self, cuboid: Sequence[int]) -> bool:
        """Whether an aligned box with these sides fits (up to rotation):
        any ``c_k <= S_k`` subset of a clique dimension spans a sub-box."""
        return geometry.contains_cuboid(self.dims, cuboid)

    def links(self) -> LinkTable:
        """Directed clique links.  Dense id layout: dimension k occupies
        the slot block ``N * sum_{i<k} S_i``, and the link from cell ``u``
        to destination coordinate ``j`` in dim k has slot ``block_k +
        flat(u) * S_k + j`` — the ``j == u_k`` self-slots stay unused.
        Capacity is ``K_k * link_bw`` (trunking folds in)."""
        dims = self.dims
        n = self.num_cells
        cells = np.arange(n, dtype=np.int64)
        coords = np.stack(np.unravel_index(cells, dims), axis=1)
        link, src, dst, cap = [], [], [], []
        base = 0
        for k, a in enumerate(dims):
            if a > 1:
                for j in range(a):
                    take = coords[:, k] != j
                    nb = coords[take].copy()
                    nb[:, k] = j
                    link.append(base + cells[take] * a + j)
                    src.append(cells[take])
                    dst.append(np.ravel_multi_index(tuple(nb.T), dims))
                    cap.append(np.full(int(take.sum()), self.link_multiplicity[k] * self.link_bw))
            base += n * a
        empty = np.zeros(0, dtype=np.int64)
        return LinkTable(
            link=np.concatenate(link) if link else empty,
            src=np.concatenate(src) if src else empty.copy(),
            dst=np.concatenate(dst) if dst else empty.copy(),
            capacity=np.concatenate(cap) if cap else np.zeros(0),
            n_slots=n * sum(dims),
        )

    def sub_fabric(self, sides: Sequence[int]) -> "HyperXFabric":
        """The fabric of an aligned sub-box: any ``c_k``-subset of a clique
        dimension is itself a ``K_{c_k}`` clique, so a HyperX sub-box is
        the Hamming graph ``H(c)`` — wrap semantics never enter (contrast
        :func:`slice_fabric`).  Sides match machine dimensions
        tightest-fit and inherit their multiplicities."""
        g = canonical(sides)
        g = g + (1,) * (len(self.dims) - len(g))
        if len(g) > len(self.dims):
            raise ValueError(f"sub-box {g} has more dims than fabric {self.dims}")
        avail = sorted(range(len(self.dims)), key=lambda i: self.dims[i])
        used = set()
        out_dims, out_mult = [], []
        for side in g:
            pick = None
            for i in avail:
                if i not in used and self.dims[i] >= side:
                    pick = i
                    break
            if pick is None:
                raise ValueError(f"sub-box {g} does not fit in fabric {self.dims}")
            used.add(pick)
            out_dims.append(side)
            out_mult.append(self.link_multiplicity[pick])
        return HyperXFabric(tuple(out_dims), tuple(out_mult), link_bw=self.link_bw)


# ---------------------------------------------------------------------------
# Slice planning (the paper's technique at the job level).
# ---------------------------------------------------------------------------
def _require_ring_fabric(pod, where: str) -> None:
    """Slice planning computes wrap-aware torus bisections; anything
    without per-dimension ring structure (e.g. :class:`HyperXFabric`)
    would get silently wrong geometries, so fail loudly instead."""
    if not isinstance(pod, TorusFabric):
        raise TypeError(
            f"{where} requires a TorusFabric (per-dimension ring structure with "
            f"wrap semantics); got {type(pod).__name__} — for HyperX fabrics use "
            f"HyperXFabric.sub_fabric / repro_torch.network.isoperimetry.ranked_geometries"
        )


def slice_fabric(pod: TorusFabric, geometry_: Sequence[int]) -> TorusFabric:
    """The fabric of a cuboid slice allocated from a pod.

    Slice semantics: wrap in a dimension only where the slice covers the
    full (wrapped) pod dimension.  Slice sides are matched to pod dims
    tightest-fit.  Raises ``TypeError`` for fabrics without per-dimension
    ring structure.

    >>> pod = TorusFabric.tpu((4, 4), link_bw=1.0)
    >>> slice_fabric(pod, (4, 2)).wrap
    (True, False)
    """
    _require_ring_fabric(pod, "slice_fabric")
    g = canonical(geometry_)
    g = g + (1,) * (len(pod.dims) - len(g))
    if len(g) > len(pod.dims):
        raise ValueError(f"slice {g} has more dims than pod {pod.dims}")
    avail = sorted(range(len(pod.dims)), key=lambda i: pod.dims[i])
    dims, wrap = [], []
    used = set()
    for side in g:
        pick = None
        for i in avail:
            if i not in used and pod.dims[i] >= side:
                pick = i
                break
        if pick is None:
            raise ValueError(f"slice {g} does not fit in pod {pod.dims}")
        used.add(pick)
        dims.append(side)
        wrap.append(pod.wrap[pick] and side == pod.dims[pick])
    return TorusFabric(tuple(dims), tuple(wrap), pod.link_bw, pod.double_link_on_2)


def ranked_slice_geometries(
    pod: TorusFabric, chips: int, device: DeviceLike = "cuda"
) -> List[Tuple[Geometry, int]]:
    """All cuboid slice geometries of the requested size that fit the pod,
    as (geometry, bisection_links) pairs, best first (max bisection, ties
    broken toward the lexicographically-smallest canonical geometry).
    Candidates come from the cut table on ``device``
    (:func:`repro_torch.network.isoperimetry.fitting_geometries`); each
    slice's bisection is the exact wrap-aware :func:`slice_fabric` value.
    Raises ``TypeError`` for fabrics without per-dimension ring structure."""
    _require_ring_fabric(pod, "ranked_slice_geometries")
    from repro_torch.network.isoperimetry import fitting_geometries

    candidates = [
        tuple(int(x) for x in row) for row in fitting_geometries(pod.dims, chips, device=device)
    ]
    ranked = sorted(
        ((g, slice_fabric(pod, g).bisection_links()) for g in candidates),
        key=lambda t: (-t[1], t[0]),
    )
    if not ranked:
        raise ValueError(f"no cuboid slice of {chips} chips fits in pod {pod.dims}")
    return ranked


def best_slice_geometry(
    pod: TorusFabric, chips: int, device: DeviceLike = "cuda"
) -> Tuple[Geometry, int]:
    """Among all cuboid slices of the requested size that fit the pod, the
    geometry with maximal internal bisection (links)."""
    return ranked_slice_geometries(pod, chips, device=device)[0]


def worst_slice_geometry(pod: TorusFabric, chips: int) -> Tuple[Geometry, int]:
    """The fitting cuboid slice with *minimal* internal bisection (links),
    the adversarial baseline of the avoidable-contention ratio (host-side
    enumeration, as in the JAX package)."""
    _require_ring_fabric(pod, "worst_slice_geometry")
    worst: Optional[Tuple[Geometry, int]] = None
    for g in geometry.sub_cuboids(pod.dims, chips):
        fab = slice_fabric(pod, g)
        b = fab.bisection_links()
        if worst is None or b < worst[1] or (b == worst[1] and g > worst[0]):
            worst = (g, b)
    if worst is None:
        raise ValueError(f"no cuboid slice of {chips} chips fits in pod {pod.dims}")
    return worst
