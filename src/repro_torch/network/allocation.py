"""Processor-allocation policies, the machine state and the batch queue
simulator (port of the torus branches of ``repro.network.allocation``).

Given a machine torus of allocation units (midplanes on Blue Gene/Q) and a
stream of jobs, allocate cuboid partitions.  The policies differ in which
geometry they pick for a size and, for the scored one, where it lands:

* ``ElongatedPolicy``        — most elongated cuboid first (the worst case);
* ``ListPolicy``             — a fixed geometry per size (Mira's list);
* ``IsoperimetricPolicy``    — the paper's policy: maximal internal
  bisection first, falling back in bisection order;
* ``HintedPolicy``           — isoperimetric for contention-bound jobs,
  elongated first-fit otherwise (Section 5's scheduler hint);
* ``ContentionScoredPolicy`` — isoperimetric geometry choice plus scored
  placement (:func:`repro_torch.network.placement.best_placement`).

:class:`MachineState` keeps its occupancy grid and its exact per-size
int64 load accumulators as tensors on ``device`` (the state a deployment
holds); the policies and the event loop stay on the host.  Every pass a
run reaches — the cut tables behind the policies' rankings, the placement
search, the rank mapping and the flow drains — runs on ``device``.

A machine may be a :class:`~repro_torch.network.fabric.HyperXFabric`:
occupancy uses the same grid (a clique dimension is invariant under
coordinate relabeling, so a wrapped translate of a box is just another
aligned box), bisections are the boxes' Hamming bisections, and scored
placement degrades to first fit, since disjoint aligned boxes share no
links there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network.fabric import HyperXFabric, TorusFabric
from repro_torch.network.geometry import Geometry, bisection_links, canonical, sub_cuboids
from repro_torch.network.isoperimetry import fitting_geometries, ranked_geometries, scaled_node_dims
from repro_torch.network.mapping import RankMapping, map_ranks
from repro_torch.network.netsim import dor_paths, simulate_flows
from repro_torch.network.placement import (
    _roll,
    best_placement,
    cells_index,
    first_fits,
    int_field,
    pad_geometry,
    placement_all_to_all_traffic,
    placement_cells,
)
from repro_torch.network.routing import max_link_load, predict_pairing_time

Coord = Tuple[int, ...]

__all__ = [
    "AllocationPolicy",
    "ContentionScoredPolicy",
    "ElongatedPolicy",
    "HintedPolicy",
    "IsoperimetricPolicy",
    "JobRequest",
    "ListPolicy",
    "MachineState",
    "Placement",
    "ScheduledJob",
    "SimulationResult",
    "avoidable_contention_ratio",
    "simulate_queue",
]


@dataclass(frozen=True)
class JobRequest:
    """One job in the queue: ``units`` allocation units, an ``arrival``
    timestamp and a ``duration`` in the simulator's time units;
    ``contention_bound`` is the Section-5 hint :class:`HintedPolicy`
    reads.  ``geometry`` optionally carries a requested partition shape,
    which every policy tries first."""

    job_id: int
    units: int  # allocation units (midplanes / chips)
    contention_bound: bool = True
    duration: float = 1.0  # abstract time units, for the queue simulator
    arrival: float = 0.0  # submission time (0 = all queued up front)
    geometry: Optional[Geometry] = None  # requested partition shape

    def __post_init__(self):
        if self.geometry is not None:
            g = canonical(self.geometry)
            n = 1
            for a in g:
                n *= a
            if n != self.units:
                raise ValueError(
                    f"requested geometry {tuple(self.geometry)} has volume "
                    f"{n}, but the request asks for {self.units} units"
                )
            object.__setattr__(self, "geometry", g)


@dataclass(frozen=True)
class Placement:
    """A committed allocation: canonical ``geometry``, the per-machine-dim
    ``oriented`` extents placed at ``offset`` (cells may wrap), its
    internal ``bisection_links`` and the ``predicted_contention``
    shared-link score (traffic-volume units; 0.0 for unscored policies)."""

    job_id: int
    geometry: Geometry  # canonical (sorted desc)
    oriented: Tuple[int, ...]  # per-machine-dimension extent actually placed
    offset: Coord
    bisection_links: int
    predicted_contention: float = 0.0  # shared-link score (scored policies)


class MachineState:
    """Occupancy grid over the machine's allocation-unit torus, on
    ``device``.

    ``grid`` is a bool tensor; the background traffic (every placement's
    intra-job all-to-all routed on the machine torus) is kept exactly, as
    one int64 accumulator per placement size n holding the sum of the
    live placements' integer-scaled fields (value ``2 n`` x load,
    :func:`repro_torch.network.placement.int_base_loads`).  Commits add
    and releases subtract in int64, so the background after any stream is
    bit-identical to a fresh recompute.  ``dims`` may be a
    :class:`~repro_torch.network.fabric.TorusFabric` or a
    :class:`~repro_torch.network.fabric.HyperXFabric`; on the latter no
    background is kept: every minimal path of an aligned box stays in the
    box.
    """

    def __init__(self, dims: Sequence[int], device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if isinstance(dims, (TorusFabric, HyperXFabric)):
            self.fabric: Optional[object] = dims
            self.dims = dims.dims
        else:
            self.fabric = None
            self.dims = tuple(int(d) for d in dims)
        self.grid = torch.zeros(self.dims, dtype=torch.bool, device=self.device)
        self.placements: Dict[int, Placement] = {}
        self._int_loads: Dict[int, torch.Tensor] = {}
        self._live: Dict[int, int] = {}  # live placements per size in _int_loads
        self._loads: Optional[torch.Tensor] = None  # lazy float recombination

    @property
    def free_units(self) -> int:
        return int((~self.grid).sum())

    @property
    def fabric_or_dims(self):
        """The fabric this machine was built from, or its plain dims."""
        return self.fabric if self.fabric is not None else self.dims

    @property
    def is_hyperx(self) -> bool:
        """Whether the machine is a HyperX fabric."""
        return isinstance(self.fabric, HyperXFabric)

    def _geometry_bisection(self, geometry: Geometry) -> int:
        """Internal bisection of a canonical geometry under the machine's
        fabric convention (Hamming sub-box on HyperX, wrapped torus
        else)."""
        if self.is_hyperx:
            return self.fabric.sub_fabric(geometry).bisection_links()
        return bisection_links(geometry)

    def cells(self, oriented: Sequence[int], offset: Coord) -> Tuple[np.ndarray, ...]:
        return placement_cells(self.dims, oriented, offset)

    def _cells(self, oriented: Sequence[int], offset: Coord) -> Tuple[torch.Tensor, ...]:
        return cells_index(self.dims, oriented, offset, self.device)

    def find_placement(self, geometry: Sequence[int]) -> Optional[Tuple[Tuple[int, ...], Coord]]:
        """First free translate of any orientation of the cuboid; None if
        full (the reference scan's choice)."""
        return first_fits(self.grid, [geometry])[0]

    def _field(self, oriented: Tuple[int, ...], offset: Coord) -> torch.Tensor:
        """The placement's integer-scaled field; at the origin it is the
        cache itself, so callers never write it."""
        return _roll(int_field(self.dims, oriented, self.device), offset, self.dims)

    def traffic_loads_t(self, exclude: Optional[int] = None) -> torch.Tensor:
        """:meth:`traffic_loads` as a tensor on the machine's device (the
        cached one when nothing is excluded: read it, never write it)."""
        if self.is_hyperx:
            raise TypeError(
                "traffic_loads is the torus-routed background field; on a "
                "HyperX fabric disjoint aligned boxes share no links (every "
                "minimal path stays inside its own box), so there is no "
                "cross-placement background to maintain"
            )
        if exclude is not None:
            p = self.placements[exclude]
            return self._recombine(int(np.prod(p.oriented)), self._field(p.oriented, p.offset))
        if self._loads is None:
            self._loads = self._recombine()
        return self._loads

    def _recombine(self, exclude_size: Optional[int] = None, exclude_field: Optional[torch.Tensor] = None) -> torch.Tensor:
        total = torch.zeros((len(self.dims), 2) + self.dims, dtype=torch.float64, device=self.device)
        for n in sorted(self._int_loads):
            acc = self._int_loads[n]
            if n == exclude_size:
                acc = acc - exclude_field
            # a device tensor: CUDA divides by a host scalar as a product
            # with its reciprocal, which rounds apart from the CPU's division
            total += acc.to(torch.float64) / torch.tensor(2.0 * n, dtype=torch.float64, device=self.device)
        return total

    def traffic_loads(self, exclude: Optional[int] = None) -> np.ndarray:
        """(D, 2, *dims) link loads of all current placements' intra-job
        all-to-all traffic on the machine torus, recombined from the
        per-size sums as ``sum_n S_n / (2n)`` in ascending n; ``exclude``
        removes one live job's own field in the integer domain first.
        Bit-identical to the JAX package's, and to a fresh recompute."""
        return self.traffic_loads_t(exclude).cpu().numpy().copy()

    def _commit(
        self,
        job_id: int,
        geometry: Sequence[int],
        oriented: Tuple[int, ...],
        offset: Coord,
        predicted_contention: float = 0.0,
        bisection: Optional[int] = None,
    ) -> Placement:
        self.grid[self._cells(oriented, offset)] = True
        p = Placement(
            job_id=job_id,
            geometry=canonical(geometry),
            oriented=oriented,
            offset=offset,
            bisection_links=self._geometry_bisection(canonical(geometry)) if bisection is None else bisection,
            predicted_contention=predicted_contention,
        )
        self.placements[job_id] = p
        n = int(np.prod(oriented))
        if n > 1 and not self.is_hyperx:  # a single cell routes no traffic; any larger job does
            delta = self._field(oriented, offset)
            acc = self._int_loads.get(n)
            if acc is None:
                self._int_loads[n] = delta.clone()  # the field may be the cache
            else:
                acc += delta
            self._live[n] = self._live.get(n, 0) + 1
        self._loads = None  # recombined lazily
        return p

    def allocate(self, job_id: int, geometry: Sequence[int]) -> Optional[Placement]:
        """First-fit allocation (the reference scan's choice)."""
        spot = self.find_placement(geometry)
        if spot is None:
            return None
        oriented, offset = spot
        return self._commit(job_id, geometry, oriented, offset)

    def allocate_scored(self, job_id: int, geometry: Sequence[int]) -> Optional[Placement]:
        """Contention/contact-scored allocation of one geometry
        (:func:`repro_torch.network.placement.best_placement` on the
        machine's device).  On a HyperX machine scoring is vacuous — every
        free translate predicts zero shared-link contention — and this is
        first fit with a 0.0 score."""
        if self.is_hyperx:
            return self.allocate(job_id, geometry)
        cand = best_placement(self.grid, geometry, self.traffic_loads_t(), device=self.device)
        if cand is None:
            return None
        return self._commit(job_id, geometry, cand.oriented, cand.offset, cand.contention)

    def commit(
        self,
        job_id: int,
        geometry: Sequence[int],
        oriented: Tuple[int, ...],
        offset: Coord,
        predicted_contention: float = 0.0,
        bisection: Optional[int] = None,
    ) -> Placement:
        """Commit an externally chosen placement, validating it first;
        ``bisection`` overrides the recorded ``bisection_links``."""
        if job_id in self.placements:
            raise ValueError(f"job {job_id} already placed")
        oriented = tuple(int(w) for w in oriented)
        if len(oriented) != len(self.dims) or any(w < 1 or w > a for w, a in zip(oriented, self.dims)):
            raise ValueError(f"orientation {oriented} does not fit machine {self.dims}")
        if tuple(sorted(oriented, reverse=True)) != pad_geometry(geometry, len(self.dims)):
            raise ValueError(
                f"orientation {oriented} is not an arrangement of geometry {canonical(geometry)}"
            )
        if bool(self.grid[self._cells(oriented, offset)].any()):
            raise ValueError(f"placement {oriented}@{offset} overlaps occupied cells")
        return self._commit(job_id, geometry, oriented, offset, predicted_contention, bisection)

    def release(self, job_id: int) -> None:
        """Free the job's cells and subtract its traffic field exactly."""
        p = self.placements.pop(job_id)
        self.grid[self._cells(p.oriented, p.offset)] = False
        n = int(np.prod(p.oriented))
        if n > 1 and not self.is_hyperx:
            self._int_loads[n] -= self._field(p.oriented, p.offset)
            self._live[n] -= 1
            if not self._live[n]:
                # Every commit of this size is released: the sum is zero.
                del self._int_loads[n], self._live[n]
        self._loads = None


# ---------------------------------------------------------------------------
# Policies.
# ---------------------------------------------------------------------------
@lru_cache(maxsize=1024)
def _ranked(machine, units: int, device: str) -> Tuple[Tuple[Geometry, int], ...]:
    """:func:`ranked_geometries` memoised per (machine dims or HyperX
    fabric, size, device): the policies ask for the same ranking at every
    scheduling attempt."""
    return tuple(ranked_geometries(machine, units, device=device))


def _ranked_for(machine: MachineState, units: int) -> List[Tuple[Geometry, int]]:
    key = machine.fabric if machine.is_hyperx else canonical(machine.dims)
    return list(_ranked(key, int(units), str(machine.device)))


def _honor_requested_geometry(prefs: List[Geometry], request: JobRequest) -> List[Geometry]:
    """Move a request's requested geometry to the front of a policy's
    preference list; identity when the request carries none."""
    if request.geometry is None:
        return prefs
    g = request.geometry
    return [g] + [p for p in prefs if p != g]


class AllocationPolicy:
    """Base policy: a preference-ordered geometry list per request, placed
    first-fit down the list (scored policies override :meth:`allocate`)."""

    name = "base"

    def geometry_preferences(self, machine: MachineState, units: int) -> List[Geometry]:
        """Geometries to try, in preference order."""
        raise NotImplementedError

    def preferences_for(self, machine: MachineState, request: JobRequest) -> List[Geometry]:
        """Request-aware preference list (hinted policies override)."""
        return _honor_requested_geometry(self.geometry_preferences(machine, request.units), request)

    def allocate(self, machine: MachineState, request: JobRequest) -> Optional[Placement]:
        """Place the request on the machine, or return None.  Default:
        first-fit down the preference list."""
        for g in self.preferences_for(machine, request):
            placed = machine.allocate(request.job_id, g)
            if placed is not None:
                return placed
        return None


class ElongatedPolicy(AllocationPolicy):
    """Most elongated geometry first (adversarial / naive filler)."""

    name = "elongated"

    def geometry_preferences(self, machine: MachineState, units: int) -> List[Geometry]:
        return sorted(sub_cuboids(machine.dims, units), key=lambda g: (-g[0], g))


class IsoperimetricPolicy(AllocationPolicy):
    """The paper's policy: maximal internal bisection bandwidth first,
    ranked by the isoperimetry engine's bisection table on the machine's
    device."""

    name = "isoperimetric"

    def geometry_preferences(self, machine: MachineState, units: int) -> List[Geometry]:
        try:
            return [g for g, _ in _ranked_for(machine, units)]
        except ValueError:
            return []  # no cuboid of this size fits


class ListPolicy(AllocationPolicy):
    """A fixed geometry per size (Mira's predefined scheduler list)."""

    name = "list"

    def __init__(self, table: Dict[int, Geometry]):
        self.table = dict(table)

    def geometry_preferences(self, machine: MachineState, units: int) -> List[Geometry]:
        if units not in self.table:
            return []
        return [canonical(self.table[units])]


class HintedPolicy(AllocationPolicy):
    """Contention-bound jobs get isoperimetric geometries; others first-fit."""

    name = "hinted"

    def __init__(self):
        self.iso = IsoperimetricPolicy()
        self.any = ElongatedPolicy()

    def geometry_preferences(
        self, machine: MachineState, units: int, contention_bound: bool = True
    ) -> List[Geometry]:
        pol = self.iso if contention_bound else self.any
        return pol.geometry_preferences(machine, units)

    def preferences_for(self, machine: MachineState, request: JobRequest) -> List[Geometry]:
        return _honor_requested_geometry(
            self.geometry_preferences(machine, request.units, request.contention_bound), request
        )


class ContentionScoredPolicy(AllocationPolicy):
    """Isoperimetric geometry choice + contention/contact-scored placement.

    Geometries are tried in bisection order; within the first that fits,
    every free translate is scored (predicted shared-link contention
    first, snugness as the tie-break).  ``min_bisection_efficiency``
    drops geometries whose internal bisection falls below that fraction of
    the size-optimal one, so a contention-bound job waits for an efficient
    partition instead of accepting an elongated one (0.0 keeps every
    geometry)."""

    name = "contention-scored"

    def __init__(self, min_bisection_efficiency: float = 0.0):
        if not 0.0 <= min_bisection_efficiency <= 1.0:
            raise ValueError(
                f"min_bisection_efficiency must be in [0, 1], got {min_bisection_efficiency}"
            )
        self.min_bisection_efficiency = float(min_bisection_efficiency)

    def geometry_preferences(self, machine: MachineState, units: int) -> List[Geometry]:
        try:
            ranked = _ranked_for(machine, units)
        except ValueError:
            return []
        if self.min_bisection_efficiency > 0.0 and ranked[0][1] > 0:
            floor = self.min_bisection_efficiency * ranked[0][1]
            ranked = [(g, b) for g, b in ranked if b >= floor - 1e-12]
        return [g for g, _ in ranked]

    def allocate(self, machine: MachineState, request: JobRequest) -> Optional[Placement]:
        for g in self.preferences_for(machine, request):
            placed = machine.allocate_scored(request.job_id, g)
            if placed is not None:
                return placed
        return None


# ---------------------------------------------------------------------------
# Queue simulator.
# ---------------------------------------------------------------------------
@dataclass
class ScheduledJob:
    request: JobRequest
    placement: Placement
    start: float
    end: float
    predicted_comm_time: float  # pairing-benchmark proxy, time per unit volume
    mapping: Optional[RankMapping] = None  # set when the simulator maps ranks
    #: Static max-load proxy on the job's own traffic alone — the lower
    #: bound no dynamic schedule can beat (contention="simulated" only).
    comm_lower_bound: float = 0.0
    #: Flow-simulated completion of the job's traffic against the
    #: placements live at start time (contention="simulated" only).
    simulated_comm_time: Optional[float] = None
    #: Internal bisection of the granted geometry over the best achievable
    #: for this size on this machine (1.0: isoperimetrically optimal).
    bisection_efficiency: float = 1.0

    @property
    def simulated_slowdown(self) -> float:
        """Simulated completion over the static max-load lower bound
        (>= 1.0 by conservation; 1.0 when not simulated or no traffic)."""
        if self.simulated_comm_time is None or self.comm_lower_bound <= 0.0:
            return 1.0
        return self.simulated_comm_time / self.comm_lower_bound


@dataclass
class SimulationResult:
    policy: str
    jobs: List[ScheduledJob] = field(default_factory=list)
    rejected: List[int] = field(default_factory=list)

    @property
    def mean_comm_time(self) -> float:
        """Mean predicted pairing-benchmark time over scheduled jobs."""
        if not self.jobs:
            return 0.0
        return float(np.mean([j.predicted_comm_time for j in self.jobs]))

    @property
    def makespan(self) -> float:
        """Completion time of the last job (simulator time units)."""
        return max((j.end for j in self.jobs), default=0.0)

    @property
    def mean_wait(self) -> float:
        """Mean queueing delay (start - arrival) over scheduled jobs."""
        if not self.jobs:
            return 0.0
        return float(np.mean([j.start - j.request.arrival for j in self.jobs]))

    @property
    def mean_contention(self) -> float:
        """Mean predicted shared-link contention score at placement time."""
        if not self.jobs:
            return 0.0
        return float(np.mean([j.placement.predicted_contention for j in self.jobs]))

    @property
    def mean_simulated_slowdown(self) -> float:
        """Mean flow-simulated slowdown over the static max-load bound
        (jobs scheduled under ``contention="simulated"``; 1.0 otherwise)."""
        simulated = [j.simulated_slowdown for j in self.jobs if j.simulated_comm_time is not None]
        if not simulated:
            return 1.0
        return float(np.mean(simulated))

    @property
    def mean_bisection_efficiency(self) -> float:
        """Mean granted-over-optimal internal bisection across scheduled jobs."""
        if not self.jobs:
            return 1.0
        return float(np.mean([j.bisection_efficiency for j in self.jobs]))


# Traffic-sharing threshold of the measured-contention proxy (a load
# magnitude, not a time): a link is "shared" when the background carries
# more than this.
_EPS = 1e-12


def simulate_queue(
    machine_dims: Sequence[int],
    jobs: Iterable[JobRequest],
    policy: AllocationPolicy,
    unit_node_dims: Optional[Sequence[int]] = None,
    link_bw: float = 1.0,
    *,
    backfill: bool = False,
    measure_contention: bool = False,
    contention: Optional[str] = None,
    mapping_pattern: Optional[str] = None,
    double_link_on_2: bool = True,
    device: DeviceLike = "cuda",
) -> SimulationResult:
    """Online queue simulation with exact cuboid placement: a thin batch
    front end over :class:`repro_torch.network.scheduler.SchedulerService`
    (submit the stream sorted by arrival, run to quiescence).

    Jobs are served head-of-line FCFS; ``backfill=True`` lets a later job
    start while the head is blocked if it completes before the head's
    reservation (EASY backfill).  A request is rejected only if it cannot
    be placed even on an empty machine.  ``unit_node_dims`` gives the node
    dims per allocation unit (e.g. (4,4,4,4,2) for a BG/Q midplane) for
    the pairing-time proxy.

    ``contention``: None (no measurement), ``"static"`` (same as
    ``measure_contention=True``: each job's intra-job all-to-all volume on
    links shared with the placements live at its start, as
    ``placement.predicted_contention``) or ``"simulated"`` (also the
    job's traffic drained with every live job's under max-min fair
    sharing: ``simulated_comm_time`` beside the static lower bound
    ``comm_lower_bound``).  ``mapping_pattern`` maps each job's ranks
    (:func:`repro_torch.network.mapping.map_ranks`) and measures the
    named pattern's mapped loads instead.  ``machine_dims`` may be a
    :class:`~repro_torch.network.fabric.TorusFabric` or a
    :class:`~repro_torch.network.fabric.HyperXFabric`; the contention
    models are torus replays, so they raise ``ValueError`` on a HyperX
    machine, where disjoint boxes share no links.  Every pass — the placement
    search, the cut tables, the mapping and the drains — runs on
    ``device``; the measured numbers are computed exactly where the JAX
    package sums floats (in the integer domain for the all-to-all fields),
    so the card and the CPU give identical schedules and records.

    >>> jobs = [JobRequest(0, 4, duration=1.0), JobRequest(1, 4, duration=1.0)]
    >>> res = simulate_queue((2, 2, 2), jobs, IsoperimetricPolicy(), device="cpu")
    >>> [(j.placement.geometry, j.start) for j in res.jobs]
    [((2, 2, 1), 0.0), ((2, 2, 1), 0.0)]
    """
    if contention is None:
        contention = "static" if measure_contention else None
    elif contention not in ("static", "simulated"):
        raise ValueError(f"contention must be None, 'static' or 'simulated'; got {contention!r}")
    measure = contention is not None
    if mapping_pattern is not None and not measure:
        raise ValueError("mapping_pattern requires measure_contention=True (or contention=)")
    from repro_torch.network.scheduler import SchedulerService

    dev = resolve_device(device)
    fabric = machine_dims if isinstance(machine_dims, (TorusFabric, HyperXFabric)) else None
    dims = fabric.dims if fabric is not None else tuple(int(d) for d in machine_dims)
    if isinstance(fabric, HyperXFabric) and (measure or mapping_pattern is not None):
        raise ValueError(
            "contention measurement replays torus routing; on a HyperX "
            "machine disjoint boxes share no links, so there is nothing to "
            "measure — run without contention=/measure_contention/"
            "mapping_pattern"
        )

    # Live per-job mapped loads (mapping_pattern only), their running sum,
    # and the live jobs' messages (contention="simulated").
    live_mapped: Dict[int, torch.Tensor] = {}
    mapped_total = (
        torch.zeros((len(dims), 2) + dims, dtype=torch.float64, device=dev) if mapping_pattern is not None else None
    )
    live_traffic: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def on_start(service, job: ScheduledJob) -> None:
        if not measure:
            return
        machine = service.machine
        placed = job.placement
        mapping: Optional[RankMapping] = None
        if mapping_pattern is not None:
            mapping = map_ranks(
                machine.dims, placed.oriented, placed.offset,
                pattern=mapping_pattern, double_link_on_2=double_link_on_2, device=dev,
            )
            job_loads = torch.from_numpy(np.array(mapping.loads)).to(dev)
            shared = job_loads[mapped_total.clamp(min=0.0) > _EPS].sum()
            live_mapped[placed.job_id] = job_loads
            mapped_total.add_(job_loads)
            predicted = float(shared)
            lower = max_link_load(machine.dims, mapping.loads, double_link_on_2)
        else:
            # The job's integer-scaled field against the background without
            # it, both exact: the shared volume is an int64 sum.
            n = int(np.prod(placed.oriented))
            field = machine._field(placed.oriented, placed.offset)
            background = machine.traffic_loads_t(exclude=placed.job_id)
            peaks = field.flatten(2).amax(dim=2).amax(dim=1)
            host = torch.cat([field[background > _EPS].sum().reshape(1), peaks]).cpu().numpy()
            predicted = float(host[0]) / (2 * n)
            lower = max(
                [0.0] + [(0.5 if a == 2 and double_link_on_2 else 1.0) * (float(m) / (2 * n))
                         for a, m in zip(machine.dims, host[1:]) if a > 1]
            )
        job.mapping = mapping
        job.placement = dataclasses.replace(placed, predicted_contention=predicted)
        if contention == "simulated":
            if mapping is not None:
                job_traffic = mapping.machine_traffic()
            else:
                job_traffic = placement_all_to_all_traffic(machine.dims, placed.oriented, placed.offset)
            job.comm_lower_bound = lower / link_bw
            background_traffic = list(live_traffic.values())
            n_bg = sum(t[2].shape[0] for t in background_traffic)
            if job_traffic[2].shape[0]:
                triples = background_traffic + [job_traffic]
                paths = dor_paths(
                    machine.dims,
                    np.concatenate([t[0] for t in triples]),
                    np.concatenate([t[1] for t in triples]),
                    np.concatenate([t[2] for t in triples]),
                )
                sim = simulate_flows(paths, link_bw=link_bw, double_link_on_2=double_link_on_2, device=dev)
                job.simulated_comm_time = float(sim.completion[n_bg:].max())
            else:
                job.simulated_comm_time = 0.0
            live_traffic[placed.job_id] = job_traffic

    def on_release(service, job_id: int) -> None:
        released = live_mapped.pop(job_id, None)
        if released is not None:
            mapped_total.sub_(released)
        live_traffic.pop(job_id, None)

    service = SchedulerService(
        fabric if fabric is not None else dims,
        policy,
        unit_node_dims=unit_node_dims,
        link_bw=link_bw,
        backfill=backfill,
        device=dev,
        on_start=on_start,
        on_release=on_release,
    )
    for _, req in sorted(enumerate(jobs), key=lambda t: (t[1].arrival, t[0])):
        service.submit(req)
    return service.run().result()


def avoidable_contention_ratio(
    machine_dims: Sequence[int],
    units: int,
    unit_node_dims: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> float:
    """Worst/best predicted pairing time over the geometries of a size that
    fit — the paper's 'avoidable contention' factor (x2 for many BG/Q
    sizes).  The geometries come from the cut table on ``device``."""
    times = [
        predict_pairing_time(scaled_node_dims(tuple(int(x) for x in g), unit_node_dims), 1.0, 1.0).time_per_volume
        for g in fitting_geometries(machine_dims, units, device=device)
    ]
    if not times:
        raise ValueError(f"no cuboid of {units} units fits in {machine_dims}")
    return max(times) / min(times)
