"""Flow-level torus network simulation (port of ``repro.network.netsim``'s
DOR paths and its drain through the compiled backend).

Every message becomes one flow along its minimal DOR path; an antipodal
tie (a ring distance of exactly half the ring) splits it into two
half-volume subflows per tied dimension.  :func:`simulate_flows` shares
each link's bandwidth max-min fairly among the flows crossing it and
advances time from one completion to the next, as the JAX package's
``simulate_flows(..., backend="xla")`` does, through
:func:`repro_torch.network.backend.prepare_drain` and
:func:`repro_torch.network.backend.drain` on ``device``.

Path building (tie expansion and link enumeration) is host-side NumPy,
copied from the JAX package.  Not ported: the minimal-adaptive router
(``adaptive_paths``), the HyperX router (``fabric_paths``: HyperX paths
built by the JAX package drain here through
:func:`repro_torch.interop.flow_paths_from_numpy`) and the utilization
timeline, a host-side diagnostic the compiled drain refuses as well.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.network.backend import drain, prepare_drain
from repro_torch.network.geometry import volume
from repro_torch.network.routing import max_link_load

Traffic = Tuple[np.ndarray, np.ndarray, np.ndarray]

__all__ = [
    "FlowPaths",
    "FlowSimResult",
    "dor_paths",
    "link_capacities",
    "simulate_flows",
    "simulate_traffic",
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
class FlowSimResult:
    """Outcome of one flow-level simulation.

    ``completion[m]`` is the finish time of message m (the last of its
    subflows), ``makespan`` the overall finish, ``ideal_time`` the
    zero-contention bound (largest message at line rate) and ``slowdown``
    their ratio — the measured contention multiplier the static engine
    predicts as ``max_link_load``.
    """

    dims: Tuple[int, ...]
    mode: str
    completion: np.ndarray  # (n_messages,) per-message finish times
    flow_completion: np.ndarray  # (F,) per-subflow finish times
    makespan: float
    steps: int
    ideal_time: float
    link_loads: np.ndarray  # (D, 2, *dims) total routed volume

    @property
    def slowdown(self) -> float:
        """Makespan over the zero-contention bound (>= 1 whenever any
        message moves; 1.0 for empty traffic)."""
        if self.ideal_time <= 0.0:
            return 1.0
        return self.makespan / self.ideal_time


def _package_result(
    paths: FlowPaths, flow_completion: np.ndarray, steps: int, link_bw: float
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
    ``device``: the JAX package's ``simulate_flows(..., backend="xla")``
    (the same completion order and steps, makespans within 1e-9 relative
    of the NumPy engine).  Raises ``RuntimeError`` after ``max_steps``
    steps, and ``ValueError`` for ``record_utilization=True``: the
    timeline is a host-side diagnostic of the NumPy engine."""
    if link_bw <= 0.0:
        raise ValueError("link_bw must be positive")
    if record_utilization:
        raise ValueError(
            "record_utilization is a numpy-only diagnostic of the JAX package's "
            "engine; the port drains through its compiled passes"
        )
    plan = prepare_drain(paths, link_bw, double_link_on_2, device=device)
    flow_completion, steps = drain(plan, max_steps=max_steps)
    return _package_result(paths, flow_completion, steps, link_bw)


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
    """Route a ``(src, dst, vol)`` pattern with DOR and drain it in one
    call.  ``mode="adaptive"`` (the JAX package's minimal-adaptive router)
    is not ported."""
    if mode == "adaptive":
        raise NotImplementedError(
            "adaptive_paths is not ported (ROADMAP Queue 1, the network engines); use mode='dor'"
        )
    if mode != "dor":
        raise ValueError(f"unknown routing mode {mode!r}; expected 'dor' or 'adaptive'")
    src, dst, vol = traffic
    paths = dor_paths(dims, src, dst, vol, split_ties=split_ties)
    return simulate_flows(
        paths,
        link_bw=link_bw,
        double_link_on_2=double_link_on_2,
        record_utilization=record_utilization,
        device=device,
    )
