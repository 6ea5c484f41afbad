"""Flow-level network simulation (port of ``repro.network.netsim``).

Every message becomes one flow along a minimal path; an antipodal tie (a
ring distance of exactly half the ring) splits it into two half-volume
subflows per tied dimension.  Paths come from one of the routers:

* ``mode="dor"`` — dimension-ordered routing (:func:`dor_paths`, host
  NumPy, link for link what ``route_dor`` accumulates);
* ``mode="adaptive"`` — minimal-adaptive (:func:`adaptive_paths`): each
  flow routes one whole dimension per round, leaving DOR's order only for
  a dimension whose segment is much cheaper under the pattern's frozen DOR
  field, decided on ``device``
  (:func:`repro_torch.network.backend.adaptive_links`);
* on a HyperX fabric, ``"minimal"`` and ``"dal"``
  (:func:`fabric_paths`, through
  :func:`repro_torch.network.backend.hyperx_flows`).

:func:`simulate_flows` shares each link's bandwidth max-min fairly among
the flows crossing it and advances time from one completion to the next,
as the JAX package's ``simulate_flows`` does, through
:func:`repro_torch.network.backend.prepare_drain` and
:func:`repro_torch.network.backend.drain` on ``device``; with
``record_utilization=True`` the drain also records the per-step link
utilization timeline on the device.  :func:`compare_routing` and
:func:`compare_fabric_routing` measure how much of a pattern's contention
routing alone recovers.  The paper's validation experiment
(:func:`validate_prediction`) and the phased schedules of ring
collectives (:func:`simulate_phases`) are host code copied from the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.network.backend import (
    adaptive_links,
    drain,
    drain_timeline,
    hyperx_flows,
    prepare_drain,
)
from repro_torch.network.fabric import HyperXFabric, Torus, TorusFabric
from repro_torch.network.geometry import volume
from repro_torch.network.routing import max_link_load

Traffic = Tuple[np.ndarray, np.ndarray, np.ndarray]

_EPS = 1e-12

__all__ = [
    "FlowPaths",
    "FlowSimResult",
    "PhasedSimResult",
    "PredictionValidation",
    "RoutingComparison",
    "UtilizationSample",
    "adaptive_paths",
    "build_paths",
    "compare_fabric_routing",
    "compare_routing",
    "dor_paths",
    "fabric_paths",
    "link_capacities",
    "simulate_fabric_traffic",
    "simulate_flows",
    "simulate_phases",
    "simulate_traffic",
    "validate_prediction",
]


# ---------------------------------------------------------------------------
# Flow expansion: messages -> minimal-path subflows.
# ---------------------------------------------------------------------------
def _expand_tie_flows(
    dims: Tuple[int, ...],
    src: np.ndarray,
    dst: np.ndarray,
    vol: np.ndarray,
    split_ties: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Expand messages into minimal-path subflows.

    Returns ``(src, dst, vol, msg, fwd)``: per-subflow endpoints and
    volumes, the originating message index, and the chosen ring direction
    per dimension (``fwd[f, k]`` — True routes +1).  With ``split_ties``
    a message is duplicated once per antipodal-tie dimension, each copy
    carrying half the volume and one of the two directions (volume is
    conserved exactly); without, ties route forward, matching
    ``route_dor(split_ties=False)``.
    """
    d_arr = np.asarray(dims, dtype=np.int64)
    src = np.array(np.atleast_2d(np.asarray(src, dtype=np.int64)))
    dst = np.array(np.atleast_2d(np.asarray(dst, dtype=np.int64)))
    M = src.shape[0]
    vol = np.array(np.broadcast_to(np.asarray(vol, dtype=np.float64), (M,)))
    msg = np.arange(M, dtype=np.int64)
    delta = (dst - src) % d_arr
    fwd = delta * 2 <= d_arr  # ties start forward; duplicates flip below
    if split_ties:
        for k, a in enumerate(dims):
            if a <= 1:
                continue
            tie = ((dst[:, k] - src[:, k]) % a) * 2 == a
            if not tie.any():
                continue
            vol[tie] *= 0.5
            idx = np.flatnonzero(tie)
            src = np.concatenate([src, src[idx]])
            dst = np.concatenate([dst, dst[idx]])
            vol = np.concatenate([vol, vol[idx]])
            msg = np.concatenate([msg, msg[idx]])
            fwd = np.concatenate([fwd, fwd[idx]])
            fwd[-idx.shape[0]:, k] = False
    return src, dst, vol, msg, fwd


def _strides(dims: Tuple[int, ...]) -> np.ndarray:
    """C-order ravel strides of the vertex grid."""
    s = np.ones(len(dims), dtype=np.int64)
    for k in range(len(dims) - 2, -1, -1):
        s[k] = s[k + 1] * dims[k + 1]
    return s


def _segment_links(
    a: int,
    stride: int,
    plane_base: np.ndarray,
    base_vflat: np.ndarray,
    start: np.ndarray,
    hops: np.ndarray,
    fwd: np.ndarray,
    flow_idx: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Enumerate the directed links of a batch of ring segments.

    A forward segment from ring position ``s`` of ``h`` hops uses the '+'
    links leaving ``s, s+1, .., s+h-1``; a backward one the '-' links
    leaving ``s, s-1, .., s-h+1`` — the same link sets ``route_dor``
    accumulates.  Returns flat link ids and the owning flow per link.
    """
    tot = int(hops.sum())
    if tot == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy()
    rep = np.repeat(np.arange(hops.shape[0]), hops)
    j = np.arange(tot) - np.repeat(np.cumsum(hops) - hops, hops)
    sgn = np.where(fwd, 1, -1)[rep]
    pos = (start[rep] + sgn * j) % a
    links = plane_base[rep] + base_vflat[rep] + pos * stride
    return links, flow_idx[rep]


@dataclass(frozen=True)
class FlowPaths:
    """The routed form of a traffic pattern: one entry per (flow, link).

    ``msg[f]`` maps subflow f back to its originating message, ``vol[f]``
    is the subflow volume (tie splits halve), and the parallel arrays
    ``link_ids`` / ``flow_ids`` are the link x flow incidence the
    simulator waterfills over.  Link ids index the flattened
    ``(D, 2, *dims)`` load tensor layout of ``route_dor``.
    """

    dims: Tuple[int, ...]
    n_messages: int
    msg: np.ndarray  # (F,) originating message per subflow
    vol: np.ndarray  # (F,) subflow volumes
    link_ids: np.ndarray  # (P,) flat directed-link ids
    flow_ids: np.ndarray  # (P,) owning subflow per entry
    mode: str = "dor"
    # Non-torus fabrics carry their own dense per-slot capacities (in units
    # of link_bw — parallel trunked links fold in); None keeps the torus
    # layout, whose capacities come from ``link_capacities`` instead.
    capacities: Optional[np.ndarray] = None

    @property
    def n_flows(self) -> int:
        """Number of subflows (>= number of messages when ties split)."""
        return int(self.vol.shape[0])

    def link_loads(self) -> np.ndarray:
        """Total routed volume per directed link — shaped ``(D, 2, *dims)``
        for torus paths (for ``mode="dor"`` this is exactly
        ``route_dor``'s tensor), or flat ``(L,)`` in the fabric's own link
        layout when the paths carry explicit ``capacities``."""
        if self.capacities is not None:
            return np.bincount(
                self.link_ids,
                weights=self.vol[self.flow_ids],
                minlength=self.capacities.shape[0],
            )
        n = volume(self.dims)
        flat = np.bincount(
            self.link_ids,
            weights=self.vol[self.flow_ids],
            minlength=2 * len(self.dims) * n,
        )
        return flat.reshape((len(self.dims), 2) + self.dims)

    def max_link_load(self, double_link_on_2: bool = True) -> float:
        """Max per-physical-link routed volume (double links halve; on
        explicit-capacity fabrics each slot's load is normalized by its
        relative capacity instead)."""
        if self.capacities is not None:
            loads = self.link_loads()
            pos = self.capacities > 0.0
            if not pos.any():
                return 0.0
            return float((loads[pos] / self.capacities[pos]).max())
        return max_link_load(self.dims, self.link_loads(), double_link_on_2)


def _dor_links(
    dims: Tuple[int, ...],
    src: np.ndarray,
    dst: np.ndarray,
    fwd: np.ndarray,
    hops: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Link incidence of already-expanded flows under dimension order."""
    strides = _strides(dims)
    n = volume(dims)
    cur = src.copy()
    all_links: List[np.ndarray] = []
    all_flows: List[np.ndarray] = []
    for k, a in enumerate(dims):
        if a <= 1:
            continue
        act = np.flatnonzero(hops[:, k] > 0)
        if act.shape[0]:
            s = cur[act, k]
            base_vflat = cur[act] @ strides - s * strides[k]
            plane = np.where(fwd[act, k], 2 * k, 2 * k + 1) * n
            links, flows = _segment_links(
                a, int(strides[k]), plane, base_vflat, s, hops[act, k], fwd[act, k], act
            )
            all_links.append(links)
            all_flows.append(flows)
        cur[:, k] = dst[:, k]
    empty = np.zeros(0, dtype=np.int64)
    return (
        np.concatenate(all_links) if all_links else empty,
        np.concatenate(all_flows) if all_flows else empty.copy(),
    )


def dor_paths(
    dims: Sequence[int],
    src: np.ndarray,
    dst: np.ndarray,
    vol,
    split_ties: bool = True,
) -> FlowPaths:
    """Dimension-ordered paths for a batch of messages.

    Link-for-link identical to what :func:`repro_torch.network.routing.route_dor`
    accumulates: dimension k routes at coordinate ``(dst[:k], src[k:])``,
    ties split into half-volume subflows.
    """
    dims = tuple(int(a) for a in dims)
    src, dst, vol, msg, fwd = _expand_tie_flows(dims, src, dst, np.asarray(vol), split_ties)
    n_messages = int(msg.max()) + 1 if msg.shape[0] else 0
    d_arr = np.asarray(dims, dtype=np.int64)
    hops = np.minimum((dst - src) % d_arr, (src - dst) % d_arr)
    link_ids, flow_ids = _dor_links(dims, src, dst, fwd, hops)
    return FlowPaths(
        dims=dims,
        n_messages=n_messages,
        msg=msg,
        vol=vol,
        link_ids=link_ids,
        flow_ids=flow_ids,
        mode="dor",
    )


def adaptive_paths(
    dims: Sequence[int],
    src: np.ndarray,
    dst: np.ndarray,
    vol,
    split_ties: bool = True,
    divert_margin: float = 0.75,
    device: DeviceLike = "cuda",
) -> FlowPaths:
    """Minimal-adaptive paths: per-flow least-loaded dimension order.

    Two passes, both on ``device``
    (:func:`repro_torch.network.backend.adaptive_links`).  Pass 1 routes
    everything with DOR into the steady link-load field the pattern would
    produce.  Pass 2 re-routes every flow against that frozen field: at
    each step the flow compares the mean load along the whole candidate
    segment of each unrouted dimension and leaves DOR's
    lowest-dimension-first order only when some dimension is cheaper than
    the default by more than the ``divert_margin`` factor.  All decisions
    are simultaneous, so a translation-invariant pattern keeps exactly
    DOR's uniform loads and makespan, while skewed patterns (hotspot
    rows, bad permutations) rebalance.  Directions stay minimal and ties
    still split, so the total hop volume equals DOR's.  For integer or
    dyadic volumes the paths equal the JAX package's id for id."""
    dims = tuple(int(a) for a in dims)
    vol = np.asarray(vol)
    M = np.atleast_2d(np.asarray(src)).shape[0]
    mvol = np.broadcast_to(np.asarray(vol, dtype=np.float64), (M,))
    msrc = np.atleast_2d(np.asarray(src, dtype=np.int64))
    mdst = np.atleast_2d(np.asarray(dst, dtype=np.int64))
    src, dst, vol, msg, fwd = _expand_tie_flows(dims, src, dst, vol, split_ties)
    n_messages = int(msg.max()) + 1 if msg.shape[0] else 0
    link_ids, flow_ids = adaptive_links(
        dims, (msrc, mdst, mvol), (src, dst, fwd), split_ties=split_ties,
        divert_margin=divert_margin, device=device,
    )
    return FlowPaths(
        dims=dims,
        n_messages=n_messages,
        msg=msg,
        vol=vol,
        link_ids=link_ids,
        flow_ids=flow_ids,
        mode="adaptive",
    )


def build_paths(
    dims: Sequence[int],
    traffic: Traffic,
    mode: str = "dor",
    split_ties: bool = True,
    device: DeviceLike = "cuda",
) -> FlowPaths:
    """Route a ``(src, dst, vol)`` pattern with the named router (``"dor"``
    or ``"adaptive"``, the latter on ``device``)."""
    src, dst, vol = traffic
    if mode == "dor":
        return dor_paths(dims, src, dst, vol, split_ties=split_ties)
    if mode == "adaptive":
        return adaptive_paths(dims, src, dst, vol, split_ties=split_ties, device=device)
    raise ValueError(f"unknown routing mode {mode!r}; expected 'dor' or 'adaptive'")


def link_capacities(
    dims: Sequence[int], link_bw: float = 1.0, double_link_on_2: bool = True
) -> np.ndarray:
    """Per-directed-link bandwidth, shaped ``(D, 2, *dims)``.

    A length-2 dimension has two parallel physical links per vertex pair
    under the BG/Q convention, doubling its capacity; TPU-style fabrics
    pass ``double_link_on_2=False``.
    """
    dims = tuple(int(a) for a in dims)
    cap = np.full((len(dims), 2) + dims, float(link_bw))
    if double_link_on_2:
        for k, a in enumerate(dims):
            if a == 2:
                cap[k] *= 2.0
    return cap


# ---------------------------------------------------------------------------
# The simulator.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class UtilizationSample:
    """One step of the link-utilization timeline: the interval ``[start,
    end)``, the max and mean utilization over links carrying any active
    flow, the active subflow count, and the full per-link utilization
    tensor (``(D, 2, *dims)`` on a torus, flat slots on an
    explicit-capacity fabric)."""

    start: float
    end: float
    max_utilization: float
    mean_utilization: float
    active_flows: int
    utilization: Optional[np.ndarray] = None


@dataclass(frozen=True)
class FlowSimResult:
    """Outcome of one flow-level simulation.

    ``completion[m]`` is the finish time of message m (the last of its
    subflows), ``makespan`` the overall finish, ``ideal_time`` the
    zero-contention bound (largest message at line rate) and ``slowdown``
    their ratio — the measured contention multiplier the static engine
    predicts as ``max_link_load``.  ``timeline`` holds the per-step
    utilization samples of a run with ``record_utilization=True`` (empty
    otherwise).
    """

    dims: Tuple[int, ...]
    mode: str
    completion: np.ndarray  # (n_messages,) per-message finish times
    flow_completion: np.ndarray  # (F,) per-subflow finish times
    makespan: float
    steps: int
    ideal_time: float
    link_loads: np.ndarray  # (D, 2, *dims) total routed volume
    timeline: List[UtilizationSample] = field(default_factory=list)

    @property
    def slowdown(self) -> float:
        """Makespan over the zero-contention bound (>= 1 whenever any
        message moves; 1.0 for empty traffic)."""
        if self.ideal_time <= 0.0:
            return 1.0
        return self.makespan / self.ideal_time


def _package_result(
    paths: FlowPaths,
    flow_completion: np.ndarray,
    steps: int,
    link_bw: float,
    timeline: Optional[List[UtilizationSample]] = None,
) -> FlowSimResult:
    """Assemble a :class:`FlowSimResult` from per-subflow finish times."""
    F = paths.n_flows
    vol = paths.vol
    completion = np.zeros(paths.n_messages)
    if F:
        np.maximum.at(completion, paths.msg, flow_completion)
    msg_vol = (
        np.bincount(paths.msg, weights=vol, minlength=paths.n_messages)
        if F
        else np.zeros(paths.n_messages)
    )
    return FlowSimResult(
        dims=paths.dims,
        mode=paths.mode,
        completion=completion,
        flow_completion=flow_completion,
        makespan=float(flow_completion.max()) if F else 0.0,
        steps=steps,
        ideal_time=float(msg_vol.max()) / link_bw if msg_vol.shape[0] else 0.0,
        link_loads=paths.link_loads(),
        timeline=timeline if timeline is not None else [],
    )


def simulate_flows(
    paths: FlowPaths,
    link_bw: float = 1.0,
    double_link_on_2: bool = True,
    record_utilization: bool = False,
    max_steps: int = 100_000,
    device: DeviceLike = "cuda",
) -> FlowSimResult:
    """Drain a routed pattern under max-min fair link sharing on
    ``device``: the JAX package's ``simulate_flows`` (the same completion
    order and steps, makespans within 1e-9 relative of the NumPy engine).
    Raises ``RuntimeError`` after ``max_steps`` steps.

    ``record_utilization=True`` also keeps the per-step utilization
    timeline, recorded on the device inside the drain
    (:func:`repro_torch.network.backend.drain_timeline`): each sample
    holds a full per-link tensor, so keep it to drains of bounded
    steps."""
    if link_bw <= 0.0:
        raise ValueError("link_bw must be positive")
    plan = prepare_drain(paths, link_bw, double_link_on_2, device=device)
    if not record_utilization:
        flow_completion, steps = drain(plan, max_steps=max_steps)
        return _package_result(paths, flow_completion, steps, link_bw)
    flow_completion, steps, stats, util = drain_timeline(plan, max_steps=max_steps)
    shape = None if paths.capacities is not None else (len(paths.dims), 2) + tuple(paths.dims)
    timeline = [
        UtilizationSample(
            start=float(st[0]),
            end=float(st[1]),
            max_utilization=float(st[2]),
            mean_utilization=float(st[3]),
            active_flows=int(st[4]),
            utilization=u if shape is None else u.reshape(shape),
        )
        for st, u in zip(stats, util)
    ]
    return _package_result(paths, flow_completion, steps, link_bw, timeline)


def simulate_traffic(
    dims: Sequence[int],
    traffic: Traffic,
    mode: str = "dor",
    split_ties: bool = True,
    link_bw: float = 1.0,
    double_link_on_2: bool = True,
    record_utilization: bool = False,
    device: DeviceLike = "cuda",
) -> FlowSimResult:
    """Route a ``(src, dst, vol)`` pattern (``mode`` ``"dor"`` or
    ``"adaptive"``) and drain it on ``device`` in one call."""
    paths = build_paths(dims, traffic, mode=mode, split_ties=split_ties, device=device)
    return simulate_flows(
        paths,
        link_bw=link_bw,
        double_link_on_2=double_link_on_2,
        record_utilization=record_utilization,
        device=device,
    )


# ---------------------------------------------------------------------------
# The paper's validation experiment as an API.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PredictionValidation:
    """Static prediction vs simulated makespan for one pattern.

    ``predicted_time`` is ``max_link_load / link_bw``; ``simulated_time``
    the flow simulator's makespan.  For steady (translation-invariant)
    patterns the two coincide; no pattern can finish faster.
    """

    dims: Tuple[int, ...]
    predicted_time: float
    simulated_time: float
    rtol: float

    @property
    def ratio(self) -> float:
        """Simulated over predicted (1.0 when both are zero)."""
        if self.predicted_time <= 0.0:
            return 1.0
        return self.simulated_time / self.predicted_time

    @property
    def matched(self) -> bool:
        """Whether simulation confirms the prediction within ``rtol``."""
        return abs(self.simulated_time - self.predicted_time) <= (
            self.rtol * max(self.predicted_time, _EPS)
        )

    @property
    def bounded(self) -> bool:
        """Whether the simulation respects the prediction as a lower bound
        (it always should; False flags a simulator bug)."""
        return self.simulated_time >= self.predicted_time * (1.0 - self.rtol) - _EPS


def validate_prediction(
    dims: Sequence[int],
    traffic: Traffic,
    link_bw: float = 1.0,
    split_ties: bool = True,
    double_link_on_2: bool = True,
    rtol: float = 1e-6,
    device: DeviceLike = "cuda",
) -> PredictionValidation:
    """Run the paper's validation experiment for one pattern: route it with
    DOR, drain it on ``device`` and package the static prediction beside
    the simulated makespan.

    >>> from repro_torch.network.patterns import bisection_pairing
    >>> v = validate_prediction((4, 4), bisection_pairing((4, 4)), device="cpu")
    >>> v.predicted_time, v.simulated_time, v.matched
    (1.0, 1.0, True)
    """
    dims = tuple(int(a) for a in dims)
    paths = dor_paths(dims, traffic[0], traffic[1], traffic[2], split_ties=split_ties)
    predicted = paths.max_link_load(double_link_on_2) / link_bw
    res = simulate_flows(paths, link_bw=link_bw, double_link_on_2=double_link_on_2, device=device)
    return PredictionValidation(dims=dims, predicted_time=predicted, simulated_time=res.makespan, rtol=rtol)


# ---------------------------------------------------------------------------
# Phased collective schedules.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PhasedSimResult:
    """Outcome of a dependent-phase schedule: per-phase results and the
    serial total (phase k+1 starts when phase k drains)."""

    phases: Tuple[FlowSimResult, ...]
    total_time: float


def simulate_phases(
    dims: Sequence[int],
    phases: Sequence[Traffic],
    mode: str = "dor",
    split_ties: bool = True,
    link_bw: float = 1.0,
    double_link_on_2: bool = True,
    device: DeviceLike = "cuda",
) -> PhasedSimResult:
    """Simulate a sequence of dependent communication phases, each a full
    ``(src, dst, vol)`` pattern that drains on ``device`` before the next
    begins (a ring all-reduce over an axis of size n is ``2(n-1)``
    neighbour-shift phases: :func:`repro_torch.network.patterns.ring_all_reduce_phases`).
    Repeated occurrences of the *same* traffic tuple (identity, the shape
    the phase builders emit) are drained once and their result reused.

    >>> from repro_torch.network.patterns import ring_all_reduce_phases
    >>> simulate_phases((4, 2), ring_all_reduce_phases((4, 2), 0, 8.0), device="cpu").total_time
    6.0
    """
    results = []
    total = 0.0
    memo: dict = {}
    for traffic in phases:
        key = id(traffic)
        res = memo.get(key)
        if res is None:
            res = simulate_traffic(
                dims,
                traffic,
                mode=mode,
                split_ties=split_ties,
                link_bw=link_bw,
                double_link_on_2=double_link_on_2,
                device=device,
            )
            memo[key] = res
        results.append(res)
        total += res.makespan
    return PhasedSimResult(phases=tuple(results), total_time=total)


# ---------------------------------------------------------------------------
# Routing-mode comparison (what routing alone can recover).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RoutingComparison:
    """Baseline (DOR, or HyperX minimal) against adaptive (or DAL)
    makespans for one pattern on one fabric."""

    dims: Tuple[int, ...]
    dor_makespan: float
    adaptive_makespan: float

    @property
    def recovered_fraction(self) -> float:
        """Fraction of the baseline makespan the adaptive router removed
        (0.0 when routing cannot help, e.g. any translation-invariant
        pattern, whose load field is already uniform)."""
        if self.dor_makespan <= 0.0:
            return 0.0
        return (self.dor_makespan - self.adaptive_makespan) / self.dor_makespan


def compare_routing(
    dims: Sequence[int],
    traffic: Traffic,
    split_ties: bool = True,
    link_bw: float = 1.0,
    double_link_on_2: bool = True,
    device: DeviceLike = "cuda",
) -> RoutingComparison:
    """How much of a pattern's contention routing alone recovers: the same
    traffic drained on ``device`` under DOR and under the minimal-adaptive
    router.  The paper's argument is geometric: for the contention its
    partition geometries avoid, the recovered fraction is ~0 — no minimal
    router spreads a uniform load field any flatter — whereas geometry
    changes the field itself."""
    dims = tuple(int(a) for a in dims)
    kw = dict(split_ties=split_ties, link_bw=link_bw, double_link_on_2=double_link_on_2, device=device)
    t_dor = simulate_traffic(dims, traffic, mode="dor", **kw).makespan
    t_adp = simulate_traffic(dims, traffic, mode="adaptive", **kw).makespan
    return RoutingComparison(dims=dims, dor_makespan=t_dor, adaptive_makespan=t_adp)


# ---------------------------------------------------------------------------
# Fabric-dispatching entry points (torus or HyperX through one API).
# ---------------------------------------------------------------------------
def _fabric_dims(fabric) -> Tuple[int, ...]:
    if isinstance(fabric, (TorusFabric, Torus, HyperXFabric)):
        return fabric.dims
    return tuple(int(a) for a in fabric)


def fabric_paths(
    fabric,
    traffic: Traffic,
    mode: Optional[str] = None,
    split_ties: bool = True,
    device: DeviceLike = "cuda",
) -> FlowPaths:
    """Route a ``(src, dst, vol)`` pattern on any fabric.

    Torus fabrics (or plain dims) go to :func:`build_paths` (``mode``
    ``"dor"``, the default, or ``"adaptive"``).  HyperX fabrics route
    with :func:`repro_torch.network.backend.hyperx_flows` on ``device``
    (``mode`` ``"minimal"``, the default, or ``"dal"``) and carry the
    fabric's dense per-slot capacities in units of ``link_bw``, so the
    same max-min drain prices trunked clique links."""
    if isinstance(fabric, HyperXFabric):
        src, dst, vol = traffic
        M = np.atleast_2d(np.asarray(src)).shape[0]
        volb = np.broadcast_to(np.asarray(vol, dtype=np.float64), (M,))
        msg, fvol, link_ids, flow_ids = (
            t.cpu().numpy() for t in hyperx_flows(fabric.dims, src, dst, volb, mode or "minimal", device=device)
        )
        return FlowPaths(
            dims=fabric.dims,
            n_messages=M,
            msg=msg,
            vol=fvol,
            link_ids=link_ids,
            flow_ids=flow_ids,
            mode=mode or "minimal",
            capacities=fabric.links().dense_capacities() / fabric.link_bw,
        )
    return build_paths(_fabric_dims(fabric), traffic, mode=mode or "dor", split_ties=split_ties, device=device)


def simulate_fabric_traffic(
    fabric,
    traffic: Traffic,
    mode: Optional[str] = None,
    split_ties: bool = True,
    link_bw: float = 1.0,
    double_link_on_2: bool = True,
    record_utilization: bool = False,
    device: DeviceLike = "cuda",
) -> FlowSimResult:
    """Route and drain a pattern on any fabric in one call, on ``device``
    (on a torus, :func:`simulate_traffic` exactly)."""
    paths = fabric_paths(fabric, traffic, mode=mode, split_ties=split_ties, device=device)
    return simulate_flows(
        paths,
        link_bw=link_bw,
        double_link_on_2=double_link_on_2,
        record_utilization=record_utilization,
        device=device,
    )


def compare_fabric_routing(
    fabric,
    traffic: Traffic,
    split_ties: bool = True,
    link_bw: float = 1.0,
    double_link_on_2: bool = True,
    device: DeviceLike = "cuda",
) -> RoutingComparison:
    """Baseline against adaptive routing on any fabric: on a torus DOR
    against minimal-adaptive (:func:`compare_routing`), on HyperX minimal
    dimension-ordered against DAL.  ``recovered_fraction`` is ~0 for
    steady translation-invariant patterns on both topologies and positive
    only for skewed fields."""
    base_mode, adp_mode = ("minimal", "dal") if isinstance(fabric, HyperXFabric) else ("dor", "adaptive")
    kw = dict(split_ties=split_ties, link_bw=link_bw, double_link_on_2=double_link_on_2, device=device)
    t_base = simulate_fabric_traffic(fabric, traffic, mode=base_mode, **kw).makespan
    t_adp = simulate_fabric_traffic(fabric, traffic, mode=adp_mode, **kw).makespan
    return RoutingComparison(dims=_fabric_dims(fabric), dor_makespan=t_base, adaptive_makespan=t_adp)
