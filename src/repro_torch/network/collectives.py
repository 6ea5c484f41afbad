"""Collective cost model on torus fabrics (port of
``repro.network.collectives``): ring closed forms for the five collectives
of a logical mesh axis embedded in a physical torus, the assignment of
logical axes to physical dimensions, and a dynamic cross-check that drains
a ring all-reduce's phases on ``device``.

The fabric carries the hardware conventions
(:class:`repro_torch.network.fabric.TorusFabric`): per-dimension wrap flags
(a slice of a pod keeps a wrap link only where it spans the full pod
dimension; a Blue Gene/Q partition always keeps them) and single or
double links on a length-2 dimension.  An axis embedded with a stride
(folded) pays it in bandwidth, and a ring counts as wrapped only when its
closing step is as cheap as its interior steps.  The closed forms are
plain Python floats, computed in the JAX package's order, so the fleet
planner's prices are bit-equal to the JAX planner's.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.device import DeviceLike
from repro_torch.network.fabric import TorusFabric

__all__ = [
    "COLLECTIVE_TIME",
    "AxisAssignment",
    "AxisEmbedding",
    "CollectiveCostModel",
    "assign_axes",
    "collective_permute_time",
    "ring_all_gather_time",
    "ring_all_reduce_time",
    "ring_all_to_all_time",
    "ring_reduce_scatter_time",
    "simulated_ring_all_reduce_time",
]


@dataclass(frozen=True)
class AxisEmbedding:
    """How a logical mesh axis of size n is laid out on the fabric: each
    axis instance is one ring (parallelism across the other axes is
    implicit).

    ``stride``  — physical hops per logical neighbour step (1 = contiguous;
                  2 = every other chip, halving effective bandwidth).
    ``wrapped`` — whether the embedded ring closes (torus ring) or is a chain.
    """

    size: int
    stride: int = 1
    wrapped: bool = True

    @property
    def ring_bw_factor(self) -> float:
        """Effective per-direction bandwidth multiplier of the embedding."""
        base = 1.0 / self.stride
        return base

    @classmethod
    def from_mapping(cls, mapping, mesh_shape: Sequence[int], axis: int) -> "AxisEmbedding":
        """Embedding measured from an explicit rank mapping.

        ``mapping`` is a :class:`repro_torch.network.mapping.RankMapping` (or
        anything with ``dims``, ``coords`` and optional per-dimension
        ``wrap`` flags); ranks are raveled row-major over ``mesh_shape``.
        ``stride`` is the *max* physical hop count between consecutive
        ranks along the axis (conservative: the slowest neighbour step
        paces a ring collective), and the embedding counts as ``wrapped``
        only when the ring-closing step is no longer than the interior
        ones — a cheap wrap is what lets both directions be used.  Hop
        counts honour the mapping's ``wrap`` flags, so a closing step
        never rides a wrap link the fabric does not have.
        """
        from repro_torch.network.mapping import mesh_axis_hops

        size = int(mesh_shape[axis])
        if size <= 1:
            return cls(size=size, stride=1, wrapped=True)
        interior, wrap = mesh_axis_hops(
            mapping.dims, mapping.coords, mesh_shape, axis,
            getattr(mapping, "wrap", None),
        )
        return cls(
            size=size,
            stride=max(1, interior),
            wrapped=0 < wrap <= max(1, interior),
        )


def ring_all_gather_time(bytes_out: float, emb: AxisEmbedding, link_bw: float) -> float:
    """Time to all-gather so each chip ends with ``bytes_out`` total
    (each chip contributes bytes_out / n)."""
    n = emb.size
    if n <= 1:
        return 0.0
    shard = bytes_out / n
    steps_bytes = shard * (n - 1)
    directions = 2.0 if emb.wrapped else 1.0  # bidirectional exchange on a ring
    return steps_bytes / (directions * link_bw * emb.ring_bw_factor)


def ring_reduce_scatter_time(bytes_in: float, emb: AxisEmbedding, link_bw: float) -> float:
    """Time to reduce-scatter a per-chip buffer of ``bytes_in``."""
    n = emb.size
    if n <= 1:
        return 0.0
    shard = bytes_in / n
    steps_bytes = shard * (n - 1)
    directions = 2.0 if emb.wrapped else 1.0
    return steps_bytes / (directions * link_bw * emb.ring_bw_factor)


def ring_all_reduce_time(bytes_in: float, emb: AxisEmbedding, link_bw: float) -> float:
    """Bandwidth-optimal all-reduce = reduce-scatter + all-gather."""
    return ring_reduce_scatter_time(bytes_in, emb, link_bw) + ring_all_gather_time(
        bytes_in, emb, link_bw
    )


def ring_all_to_all_time(bytes_in: float, emb: AxisEmbedding, link_bw: float) -> float:
    """All-to-all of a per-chip buffer of ``bytes_in`` over the axis.

    Ring all-to-all is bisection-bound: max directed-link load is
    bytes_in/n * n^2/8 (ties split) on a wrapped ring, n^2/4 on a chain.
    """
    n = emb.size
    if n <= 1:
        return 0.0
    per_peer = bytes_in / n
    if emb.wrapped:
        load = per_peer * n * n / 8.0
    else:
        load = per_peer * n * n / 4.0
    return load / (link_bw * emb.ring_bw_factor)


def collective_permute_time(bytes_in: float, emb: AxisEmbedding, link_bw: float) -> float:
    """Neighbour shift along the axis (pipelining / ring matmul step)."""
    return bytes_in * emb.stride / link_bw


COLLECTIVE_TIME = {
    "all-reduce": ring_all_reduce_time,
    "all-gather": ring_all_gather_time,
    "reduce-scatter": ring_reduce_scatter_time,
    "all-to-all": ring_all_to_all_time,
    "collective-permute": collective_permute_time,
}


def simulated_ring_all_reduce_time(
    dims: Sequence[int],
    axis: int,
    bytes_in: float,
    link_bw: float = 1.0,
    double_link_on_2: bool = False,
    device: DeviceLike = "cuda",
) -> float:
    """Dynamic cross-check of :func:`ring_all_reduce_time`: the ``2(n-1)``
    neighbour-shift phases of a bidirectional ring all-reduce over physical
    dimension ``axis`` (:func:`repro_torch.network.patterns.ring_all_reduce_phases`)
    drained through the flow simulator on ``device``.  For a contiguous
    wrapped ring it equals the closed form exactly.

    >>> simulated_ring_all_reduce_time((8,), 0, 64.0, device="cpu")
    56.0
    >>> ring_all_reduce_time(64.0, AxisEmbedding(8), 1.0)
    56.0
    """
    from repro_torch.network.netsim import simulate_phases
    from repro_torch.network.patterns import ring_all_reduce_phases

    phases = ring_all_reduce_phases(dims, axis, bytes_in)
    return simulate_phases(
        dims,
        phases,
        link_bw=link_bw,
        double_link_on_2=double_link_on_2,
        device=device,
    ).total_time


# ---------------------------------------------------------------------------
# Axis assignment: mapping logical mesh axes onto physical torus dimensions.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AxisAssignment:
    """Assignment of each logical axis to an ordered group of physical dims."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    phys_groups: Tuple[Tuple[int, ...], ...]  # indices into fabric.dims
    embeddings: Tuple[AxisEmbedding, ...]

    def embedding(self, axis: str) -> AxisEmbedding:
        """The embedding of one logical axis, looked up by name."""
        return self.embeddings[self.axis_names.index(axis)]


def assign_axes(
    fabric: TorusFabric,
    axis_sizes: Dict[str, int],
    order_hint: Optional[Sequence[str]] = None,
    mapping=None,
) -> AxisAssignment:
    """Greedy optimal-by-construction assignment of mesh axes to physical dims.

    Each axis must occupy a set of whole physical dimensions whose product is
    the axis size (a device mesh is a reshape of the fabric's chips).  Axes earlier in
    ``order_hint`` (default: larger collective pressure ≈ larger axis first)
    get contiguous, wrapped dimensions first.  An axis spanning multiple
    physical dims is embedded as a snake: wrapped iff all its dims wrap, and
    contiguous (stride 1) because the snake traverses physically adjacent
    chips.

    ``mapping`` (a :class:`repro_torch.network.mapping.RankMapping` over the same
    rank count, ranks raveled row-major over ``axis_sizes`` in insertion
    order) replaces each axis's *assumed* stride-1/wrapped embedding with
    the measured one (:meth:`AxisEmbedding.from_mapping`): a mapping that
    folds an axis pays its real stride, and a ring only counts as wrapped
    when its closing step is as cheap as its interior steps.  The
    dimension grouping itself stays geometric.
    """
    names = list(order_hint) if order_hint else sorted(
        axis_sizes, key=lambda a: -axis_sizes[a]
    )
    if set(names) != set(axis_sizes):
        raise ValueError("order_hint must cover exactly the axis names")
    remaining = list(range(len(fabric.dims)))
    groups: Dict[str, Tuple[int, ...]] = {}
    for name in names:
        size = axis_sizes[name]
        if size == 1:
            groups[name] = ()
            continue
        got = _find_dim_group(fabric, remaining, size)
        if got is None:
            raise ValueError(
                f"axis {name}={size} cannot be embedded in remaining dims "
                f"{[fabric.dims[i] for i in remaining]} of fabric {fabric.dims}"
            )
        groups[name] = got
        for i in got:
            remaining.remove(i)
    ordered = tuple(axis_sizes.keys())
    mesh_shape = tuple(axis_sizes[n] for n in ordered)
    embeddings = {}
    for name in names:
        size = axis_sizes[name]
        dims = groups[name]
        if mapping is not None:
            embeddings[name] = AxisEmbedding.from_mapping(
                mapping, mesh_shape, ordered.index(name)
            )
        else:
            wrapped = all(fabric.wrap[i] for i in dims) if dims else True
            embeddings[name] = AxisEmbedding(size=size, stride=1, wrapped=wrapped)
    return AxisAssignment(
        axis_names=ordered,
        axis_sizes=tuple(axis_sizes[n] for n in ordered),
        phys_groups=tuple(groups[n] for n in ordered),
        embeddings=tuple(embeddings[n] for n in ordered),
    )


def _find_dim_group(
    fabric: TorusFabric, remaining: List[int], size: int
) -> Optional[Tuple[int, ...]]:
    """Smallest group of remaining physical dims whose product equals size,
    preferring wrapped dims (ring > chain for collectives)."""
    for k in range(1, len(remaining) + 1):
        candidates = []
        for combo in itertools.combinations(remaining, k):
            if math.prod(fabric.dims[i] for i in combo) == size:
                n_wrapped = sum(bool(fabric.wrap[i]) for i in combo)
                candidates.append((-n_wrapped, combo))
        if candidates:
            return min(candidates)[1]
    return None


@dataclass
class CollectiveCostModel:
    """Prices collectives for a mesh built on a fabric with an assignment."""

    fabric: TorusFabric
    assignment: AxisAssignment

    def time(self, collective: str, axis: str, bytes_in: float) -> float:
        """Seconds for one collective (:data:`COLLECTIVE_TIME` key) of
        ``bytes_in`` per-chip bytes over the named logical axis."""
        emb = self.assignment.embedding(axis)
        fn = COLLECTIVE_TIME[collective]
        return fn(bytes_in, emb, self.fabric.link_bw)

    def effective_axis_bandwidth(self, axis: str) -> float:
        """Algorithmic bandwidth of an all-gather over the axis (bytes/s)."""
        emb = self.assignment.embedding(axis)
        if emb.size <= 1:
            return math.inf
        t = ring_all_gather_time(1.0, emb, self.fabric.link_bw)
        return 1.0 / t
