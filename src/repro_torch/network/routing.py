"""Dimension-ordered routing (DOR) link loads on a torus (port of the
torus part of ``repro.network.routing``).

:func:`route_dor` is the JAX package's ``route_dor(..., backend="xla")``:
the per-directed-link load tensor of a message batch, computed by
:func:`repro_torch.network.backend.route_loads` on ``device``.  Ties (a
ring distance of exactly half the ring) split their volume across both
directions with ``split_ties=True``; a dimension of length 2 has two
parallel links under the Blue Gene/Q convention, which
:func:`max_link_load` applies at query time.  The closed forms for
translation-invariant patterns (:func:`uniform_offset_max_load`,
:func:`all_to_all_max_load`) and the pairing-benchmark prediction are
host arithmetic, copied from the JAX package.

On a :class:`~repro_torch.network.fabric.HyperXFabric`,
:func:`route_hyperx` routes minimally (dimension-ordered direct clique
hops) or with DAL (load-balanced over the dimension orders) through
:func:`repro_torch.network.backend.hyperx_flows` on ``device``;
:func:`route_pattern` dispatches on the fabric.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.network.backend import hyperx_blocks, hyperx_flows, hyperx_loads, route_loads
from repro_torch.network.fabric import HyperXFabric, Torus, TorusFabric
from repro_torch.network.geometry import canonical, volume

Coord = Tuple[int, ...]

__all__ = [
    "Coord",
    "LinkLoads",
    "PairingPrediction",
    "all_to_all_max_load",
    "hyperx_all_to_all_max_load",
    "hyperx_max_link_load",
    "max_link_load",
    "pairing_speedup",
    "predict_pairing_time",
    "route_dor",
    "route_hyperx",
    "route_pattern",
    "simulate_pattern",
    "uniform_offset_max_load",
]


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
    effective load; single-link fabrics pass ``double_link_on_2=False``.
    """
    dims = tuple(dims)
    m = 0.0
    for k, a in enumerate(dims):
        if a == 1:
            continue
        scale = 0.5 if (a == 2 and double_link_on_2) else 1.0
        m = max(m, scale * float(loads[k].max()))
    return m


@dataclass
class LinkLoads:
    """Directed-link load accounting on a torus under DOR routing: paths
    are buffered and routed in one :func:`route_dor` call on ``device`` at
    the first query."""

    dims: Tuple[int, ...]
    split_ties: bool = True
    double_link_on_2: bool = True
    device: DeviceLike = "cuda"
    _src: List[np.ndarray] = field(default_factory=list, repr=False)
    _dst: List[np.ndarray] = field(default_factory=list, repr=False)
    _vol: List[np.ndarray] = field(default_factory=list, repr=False)
    _loads: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        self.dims = tuple(int(a) for a in self.dims)

    def add_path(self, src: Coord, dst: Coord, vol: float) -> None:
        """Route vol from src to dst (buffered; computed lazily)."""
        self.add_batch([src], [dst], [vol])

    def add_batch(self, src: Sequence[Sequence[int]], dst: Sequence[Sequence[int]], vol) -> None:
        src = np.atleast_2d(np.asarray(src, dtype=np.int64))
        dst = np.atleast_2d(np.asarray(dst, dtype=np.int64))
        vol = np.broadcast_to(np.asarray(vol, dtype=np.float64), (src.shape[0],))
        self._src.append(src)
        self._dst.append(dst)
        self._vol.append(np.array(vol))
        self._loads = None

    def _compute(self) -> np.ndarray:
        if self._loads is None:
            if self._src:
                self._loads = route_dor(
                    self.dims,
                    np.concatenate(self._src),
                    np.concatenate(self._dst),
                    np.concatenate(self._vol),
                    split_ties=self.split_ties,
                    device=self.device,
                )
            else:
                self._loads = np.zeros((len(self.dims), 2) + self.dims)
        return self._loads

    @property
    def loads(self) -> List[List[np.ndarray]]:
        """``loads[k][d]`` with the torus shape: snapshots of the lazily
        computed tensor (re-read after adding traffic)."""
        arr = self._compute()
        return [[arr[k, d] for d in range(2)] for k in range(len(self.dims))]

    def load_array(self) -> np.ndarray:
        """The (D, 2, *dims) load tensor."""
        return self._compute()

    def max_load(self) -> float:
        """Maximum load on any directed physical link (double links halve)."""
        return max_link_load(self.dims, self._compute(), self.double_link_on_2)

    def total_hop_volume(self) -> float:
        return float(self._compute().sum())


def simulate_pattern(
    dims: Sequence[int],
    traffic: Iterable[Tuple[Coord, Coord, float]],
    split_ties: bool = True,
    device: DeviceLike = "cuda",
) -> LinkLoads:
    """Route explicit (src, dst, vol) traffic; accepts any iterable of triples."""
    ll = LinkLoads(tuple(dims), split_ties=split_ties, device=device)
    triples = list(traffic)
    if triples:
        srcs, dsts, vols = zip(*triples)
        ll.add_batch(np.asarray(srcs), np.asarray(dsts), np.asarray(vols, dtype=np.float64))
    return ll


# ---------------------------------------------------------------------------
# Closed forms for translation-invariant patterns.
# ---------------------------------------------------------------------------
def uniform_offset_max_load(
    dims: Sequence[int],
    offset: Sequence[int],
    vol: float = 1.0,
    split_ties: bool = True,
    double_link_on_2: bool = True,
) -> float:
    """Max directed-link load when every vertex sends vol to vertex+offset:
    an offset of delta on a ring of length a loads each link of the chosen
    direction with ``vol * min(delta, a-delta)`` (halved for a split tie,
    and again on a Blue Gene/Q double link)."""
    m = 0.0
    for a, off in zip(dims, offset):
        if a == 1:
            continue
        delta = off % a
        if delta == 0:
            continue
        d = min(delta, a - delta)
        load = vol * d
        if 2 * d == a and split_ties:
            load /= 2.0
        if a == 2 and double_link_on_2:
            load /= 2.0  # double link
        m = max(m, load)
    return m


def all_to_all_max_load(
    dims: Sequence[int],
    vol_per_pair: float = 1.0,
    split_ties: bool = True,
    double_link_on_2: bool = True,
) -> float:
    """Max link load of a full all-to-all (every ordered pair exchanges
    vol_per_pair) under DOR: each of the N/a_k dimension-k rings carries N
    messages per ordered ring offset, and the per-direction hop volumes
    are counted explicitly (the antipodal tie split or sent forward)."""
    dims = tuple(dims)
    n = volume(dims)
    worst = 0.0
    for k, a in enumerate(dims):
        if a == 1:
            continue
        fwd_hop_vol = 0.0  # per-ring hop volume in the + direction
        bwd_hop_vol = 0.0
        for delta in range(1, a):
            d = min(delta, a - delta)
            if 2 * delta == a:  # antipodal tie
                if split_ties:
                    fwd_hop_vol += n * d / 2.0
                    bwd_hop_vol += n * d / 2.0
                else:
                    fwd_hop_vol += n * d
            elif delta < a - delta:
                fwd_hop_vol += n * d
            else:
                bwd_hop_vol += n * d
        load = max(fwd_hop_vol, bwd_hop_vol) * vol_per_pair / a
        if a == 2 and double_link_on_2:
            load /= 2.0
        worst = max(worst, load)
    return worst


# ---------------------------------------------------------------------------
# The paper's bisection-pairing benchmark.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PairingPrediction:
    dims: Tuple[int, ...]
    max_link_load: float  # per unit message volume
    time_per_volume: float  # time per unit of per-pair message volume
    bisection_links: int


def predict_pairing_time(
    dims: Sequence[int],
    message_bytes: float,
    link_bw_bytes_s: float,
    split_ties: bool = True,
    double_link_on_2: bool = True,
) -> PairingPrediction:
    """Predicted completion time of one round of the pairing benchmark."""
    from repro_torch.network.patterns import furthest_offset

    dims = canonical(dims)
    off = furthest_offset(dims)
    load = uniform_offset_max_load(dims, off, 1.0, split_ties=split_ties, double_link_on_2=double_link_on_2)
    return PairingPrediction(
        dims=dims,
        max_link_load=load,
        time_per_volume=load / link_bw_bytes_s,
        bisection_links=Torus(dims).bisection_links(),
    )


def pairing_speedup(dims_a: Sequence[int], dims_b: Sequence[int], split_ties: bool = True) -> float:
    """Predicted execution-time ratio T(a) / T(b) of the pairing benchmark
    between two equal-size partition geometries (paper Figures 3-4)."""
    a = predict_pairing_time(dims_a, 1.0, 1.0, split_ties)
    b = predict_pairing_time(dims_b, 1.0, 1.0, split_ties)
    return a.max_link_load / b.max_link_load


# ---------------------------------------------------------------------------
# HyperX routing: minimal (dimension-ordered direct hops) and DAL.
# ---------------------------------------------------------------------------
def route_hyperx(
    fabric: HyperXFabric,
    src: np.ndarray,
    dst: np.ndarray,
    vol,
    mode: str = "minimal",
    rounds: int = 2,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Per-directed-link loads of a message batch on a HyperX fabric, on
    ``device``: a flat ``(N * sum(S_k),)`` vector in the dense link-id
    layout of :meth:`~repro_torch.network.fabric.HyperXFabric.links`
    (unused self-slots stay zero).  ``mode="minimal"`` corrects
    coordinates in canonical dimension order — every hop is direct, path
    length equals Hamming distance; ``mode="dal"`` also load-balances
    across dimension orders (:func:`repro_torch.network.backend.hyperx_flows`).
    Minimal loads are exact sums, equal to the JAX package's bit for bit
    for integer volumes.

    >>> import numpy as np
    >>> hx = HyperXFabric((4, 4), link_bw=1.0)
    >>> loads = route_hyperx(hx, np.array([[0, 0]]), np.array([[2, 3]]), 1.0, device="cpu")
    >>> float(loads.sum())   # two direct hops: dim 0 then dim 1
    2.0
    """
    M = np.atleast_2d(np.asarray(src)).shape[0]
    vol = np.broadcast_to(np.asarray(vol, dtype=np.float64), (M,))
    _, n_slots = hyperx_blocks(fabric.dims)
    _, fvol, link_ids, flow_ids = hyperx_flows(fabric.dims, src, dst, vol, mode, rounds, device=device)
    if not link_ids.shape[0]:
        return np.zeros(n_slots)
    return hyperx_loads(fvol, link_ids, flow_ids, n_slots)


def hyperx_max_link_load(fabric: HyperXFabric, loads: np.ndarray) -> float:
    """Max per-physical-link load of a :func:`route_hyperx` vector:
    dimension k's ``K_k`` trunked parallel links share their dimension's
    traffic, dividing the effective load (the HyperX analogue of the torus
    double-link halving)."""
    dims = fabric.dims
    n = volume(dims)
    m = 0.0
    base = 0
    for k, a in enumerate(dims):
        block = loads[base: base + n * a]
        if block.shape[0]:
            m = max(m, float(block.max()) / fabric.link_multiplicity[k])
        base += n * a
    return m


def hyperx_all_to_all_max_load(fabric: HyperXFabric, vol_per_pair: float = 1.0) -> float:
    """Exact max effective link load of all-to-all on a HyperX fabric under
    minimal dimension-ordered routing: the dim-k link out of any cell is
    shared by exactly ``N / S_k`` ordered pairs, so

        max load = vol_per_pair * N / min_k (S_k * K_k).

    Covering a dimension fully maximises the denominator, so elongated
    boxes minimise all-to-all contention on HyperX, the opposite of the
    torus preference.

    >>> hyperx_all_to_all_max_load(HyperXFabric((4, 4), link_bw=1.0))
    4.0
    >>> hyperx_all_to_all_max_load(HyperXFabric((16, 1), link_bw=1.0))
    1.0
    """
    n = volume(fabric.dims)
    denom = min(
        a * k for a, k in zip(fabric.dims, fabric.link_multiplicity) if a > 1
    ) if any(a > 1 for a in fabric.dims) else None
    if denom is None:
        return 0.0
    return vol_per_pair * n / denom


def route_pattern(
    fabric,
    src: np.ndarray,
    dst: np.ndarray,
    vol,
    *,
    mode: Optional[str] = None,
    split_ties: bool = True,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Route a message batch on any fabric, on ``device``.

    * a :class:`TorusFabric`, a :class:`Torus` or plain dims:
      :func:`route_dor`'s ``(D, 2, *dims)`` tensor (``mode`` must be
      ``"dor"`` or None; the adaptive torus router lives in
      :mod:`repro_torch.network.netsim`, where path state exists);
    * a :class:`HyperXFabric`: :func:`route_hyperx`'s flat load vector
      (``mode`` ``"minimal"``, the default, or ``"dal"``; ``split_ties``
      does not apply: clique hops have no antipodal ties)."""
    if isinstance(fabric, HyperXFabric):
        return route_hyperx(fabric, src, dst, vol, mode=mode or "minimal", device=device)
    dims = fabric.dims if isinstance(fabric, (TorusFabric, Torus)) else tuple(int(a) for a in fabric)
    if mode not in (None, "dor"):
        raise ValueError(
            f"torus route_pattern supports mode='dor' only (got {mode!r}); "
            f"adaptive torus routing lives in the netsim module"
        )
    return route_dor(dims, src, dst, vol, split_ties=split_ties, device=device)
