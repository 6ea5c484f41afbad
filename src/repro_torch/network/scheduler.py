"""Event-sourced scheduler service over the allocation engine (port of
``repro.network.scheduler``).

One :class:`SchedulerService` owns a :class:`~repro_torch.network.
allocation.MachineState` (its grid and background fields on ``device``), a
priority waiting queue and a pending-event heap on the host, and exposes
events as the only way state changes:

``Arrival``   a job enters the waiting queue (or is shed, see below).
``Start``     the policy placed a job; the record carries the placement.
``Complete``  a running job's duration elapsed; its cells free.
``Fail``      cells die: jobs on them are evacuated (a derived ``Preempt``
              per victim) and requeued with their remaining duration, and
              the cells leave the free pool until repaired.
``Preempt``   a running job is suspended (cells free, remaining duration
              retained) until an explicit ``Reclaim`` resumes it.
``Reclaim``   repairs failed cells and/or requeues a suspended job.
``Reject``    a request that cannot be placed even on an empty (degraded)
              machine, or an arrival shed by backpressure.

Every processed event is appended to :attr:`SchedulerService.log`, an
append-only, deterministically ordered record; replaying its ``input``
records through a fresh service (:func:`replay_events`) reproduces it
event for event.  Events are processed in ``(time, kind, seq)`` order,
and events closer than :func:`time_eps` (64 machine epsilons at the
magnitude of the times involved) are one scheduling instant, processed
grid-freeing events first.

Example — two jobs on a 2x2x2 machine, the second must wait:

>>> from repro_torch.network.allocation import IsoperimetricPolicy, JobRequest
>>> svc = SchedulerService((2, 2, 2), IsoperimetricPolicy(), device="cpu")
>>> svc.submit(JobRequest(0, 8, duration=2.0))
>>> svc.submit(JobRequest(1, 4, duration=1.0, arrival=0.5))
>>> res = svc.run().result()
>>> [(j.request.job_id, j.start) for j in res.jobs]
[(0, 0.0), (1, 2.0)]
>>> [(e.kind, e.job_id) for e in svc.log]  # doctest: +NORMALIZE_WHITESPACE
[('arrival', 0), ('start', 0), ('arrival', 1), ('complete', 0),
 ('start', 1), ('complete', 1)]
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.network.allocation import (
    AllocationPolicy,
    JobRequest,
    MachineState,
    Placement,
    ScheduledJob,
    SimulationResult,
)
from repro_torch.network.geometry import Geometry
from repro_torch.network.isoperimetry import best_bisection_geometry, scaled_node_dims
from repro_torch.network.placement import cells_index, first_fits, placement_cells
from repro_torch.network.routing import hyperx_all_to_all_max_load, predict_pairing_time
from repro_torch.obs import TRACER as _TRACER
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, failure_cells

Coord = Tuple[int, ...]

# Event kinds.  _RANK is the processing order inside one scheduling
# instant: grid-freeing events first (they can unblock the head), then
# repairs/resumptions, then arrivals; Start/Reject are derived by the
# scheduling pass that follows, never queued.
ARRIVAL = "arrival"
START = "start"
COMPLETE = "complete"
FAIL = "fail"
PREEMPT = "preempt"
RECLAIM = "reclaim"
REJECT = "reject"
_RANK = {COMPLETE: 0, FAIL: 1, PREEMPT: 2, RECLAIM: 3, ARRIVAL: 4}

#: Relative width of one scheduling instant: 64 machine epsilons.
EPS_REL = 64.0 * float(np.finfo(np.float64).eps)


def time_eps(*times: float) -> float:
    """Scale-aware tolerance of the event clock: ``64 · eps_machine`` at
    the magnitude of the largest argument (floored at 1.0, so tiny clocks
    keep an absolute ~1.4e-14 guard).  Events closer than this are one
    scheduling instant; the contract is that genuinely distinct instants
    are separated by more than ~128 ulp of their magnitude.  The
    historical fixed ``1e-12`` is ~67x *below* one ulp at t = 1e5, where
    accumulated arrival/duration rounding made tie ordering seed-dependent.
    """
    scale = 1.0
    for t in times:
        a = abs(float(t))
        if a > scale:
            scale = a
    return EPS_REL * scale


def time_close(a: float, b: float) -> bool:
    """True when ``a`` and ``b`` are the same scheduling instant."""
    return abs(a - b) <= time_eps(a, b)


def time_le(a: float, b: float) -> bool:
    """Scale-aware ``a <= b`` (true also when the two are one instant)."""
    return a <= b or time_close(a, b)


def time_lt(a: float, b: float) -> bool:
    """Scale-aware strict ``a < b`` (false when the two are one instant)."""
    return a < b and not time_close(a, b)


@dataclass(frozen=True)
class Event:
    """One record of the append-only scheduler log.

    ``seq`` is the record's position in the log (dense, deterministic).
    ``source`` is ``"input"`` for externally injected records (arrivals,
    failures, preemptions, reclaims) and ``"derived"`` for everything the
    service concluded on its own — replaying only the input records
    through a fresh service reproduces the derived ones exactly
    (:func:`replay_events`)."""

    time: float
    kind: str
    seq: int
    job_id: Optional[int] = None
    cells: Optional[Tuple[Coord, ...]] = None
    request: Optional[JobRequest] = None  # arrival records carry the job
    placement: Optional[Placement] = None  # start records carry the decision
    priority: int = 0
    reason: Optional[str] = None  # reject/preempt annotations
    source: str = "derived"


@dataclass
class _Queued:
    request: JobRequest
    priority: int
    order: int  # enqueue sequence: FIFO within a priority level


@dataclass
class _Live:
    gen: int  # start generation: stale Complete events are discarded
    job: ScheduledJob
    priority: int


class SchedulerService:
    """Event-sourced online scheduler wrapping one
    :class:`~repro_torch.network.allocation.MachineState`.

    The scheduling pass after each event cluster reproduces the historical
    ``simulate_queue`` loop exactly: the head of the waiting queue is
    tried first (FCFS within a priority level), a blocked head caches its
    reservation — the earliest time it is guaranteed to fit, by replaying
    pending frees on a scratch grid — until *any* grid-freeing event
    (Complete, Fail, Preempt, priority eviction or a cell repair)
    invalidates it, and with ``backfill=True`` later jobs may jump a
    blocked head only if they finish by the reservation (EASY backfill).

    Beyond the batch simulator it adds:

    * ``max_waiting`` — backpressure: an arrival that would grow the
      waiting queue past the bound is shed (logged as a Reject with
      reason ``"backpressure"`` and listed in both ``shed`` and
      ``rejected``); requeued victims of failures/preemptions are never
      shed.
    * ``preempt_priority=True`` — a blocked head may evict strictly
      lower-priority running jobs (lowest priority, youngest first) when
      doing so frees enough cells; victims requeue with their remaining
      duration.
    * failure semantics — ``inject_failure`` evacuates the jobs on the
      failed cells (requeued with remaining duration — the idealised
      checkpoint-at-failure model matching
      :mod:`repro_torch.runtime.fault_tolerance`'s restore) and removes the
      cells from the free pool until ``inject_reclaim`` repairs them.

    ``on_start(service, job)`` / ``on_release(service, job_id)`` hooks run
    synchronously at placement/free time; ``simulate_queue`` uses them to
    attach its contention measurements without a second event loop.
    """

    def __init__(
        self,
        machine_dims: Sequence[int],
        policy: AllocationPolicy,
        *,
        unit_node_dims: Optional[Sequence[int]] = None,
        link_bw: float = 1.0,
        backfill: bool = False,
        max_waiting: Optional[int] = None,
        preempt_priority: bool = False,
        device: DeviceLike = "cuda",
        on_start: Optional[Callable[["SchedulerService", ScheduledJob], None]] = None,
        on_release: Optional[Callable[["SchedulerService", int], None]] = None,
    ):
        self.machine = MachineState(machine_dims, device=device)
        self.policy = policy
        if unit_node_dims is not None and self.machine.is_hyperx:
            raise ValueError(
                "unit_node_dims is the BG/Q torus node-scaling convention; "
                "HyperX machines schedule allocation-unit boxes directly"
            )
        self.unit_node_dims = unit_node_dims
        self.link_bw = float(link_bw)
        self.backfill = bool(backfill)
        self.max_waiting = max_waiting if max_waiting is None else int(max_waiting)
        self.preempt_priority = bool(preempt_priority)
        self.on_start = on_start
        self.on_release = on_release

        self.now = 0.0
        self.log: List[Event] = []
        self.scheduled: List[ScheduledJob] = []
        self.rejected: List[int] = []
        self.shed: List[int] = []
        self.failed_cells: Set[Coord] = set()

        self._pending: List[Tuple[float, int, int, str, tuple]] = []
        self._push_seq = itertools.count()
        self._waiting: List[_Queued] = []
        self._enqueue_seq = itertools.count()
        self._live: Dict[int, _Live] = {}
        self._gen = itertools.count()
        self._suspended: Dict[int, Tuple[JobRequest, int]] = {}
        # (job_id, t_res) of a blocked head: reused until a grid-freeing
        # event or a head change invalidates it (arrival-only wakes cannot
        # newly fit the head — the grid only changes on frees).
        self._blocked: Optional[Tuple[int, float]] = None
        self._opt_bisection: Dict[int, int] = {}

    # -- event intake -------------------------------------------------------
    def _push(self, time: float, kind: str, data: tuple) -> None:
        heapq.heappush(
            self._pending,
            (float(time), _RANK[kind], next(self._push_seq), kind, data),
        )

    def submit(self, request: JobRequest, priority: int = 0) -> None:
        """Queue an Arrival for ``request.arrival`` (processed at the
        current time if that is already past).  Higher ``priority`` jobs
        sit ahead of lower ones; FCFS within a level."""
        self._push(request.arrival, ARRIVAL, (request, int(priority), "input"))

    def inject_failure(self, time: float, cells: Iterable[Sequence[int]]) -> None:
        """Queue a Fail event: at ``time`` the given cells die — jobs on
        them are evacuated and requeued, the cells leave the free pool."""
        self._push(
            float(time), FAIL, (tuple(tuple(int(c) for c in cell) for cell in cells),)
        )

    def inject_preempt(self, time: float, job_id: int) -> None:
        """Queue a Preempt: suspend the running job (remaining duration is
        retained) until a Reclaim with its id requeues it.  A no-op if the
        job is not running when the event fires."""
        self._push(float(time), PREEMPT, (int(job_id),))

    def inject_reclaim(
        self,
        time: float,
        job_id: Optional[int] = None,
        cells: Optional[Iterable[Sequence[int]]] = None,
    ) -> None:
        """Queue a Reclaim: repair ``cells`` (returning them to the free
        pool) and/or requeue the suspended job ``job_id``."""
        self._push(
            float(time),
            RECLAIM,
            (
                None if job_id is None else int(job_id),
                None
                if cells is None
                else tuple(tuple(int(c) for c in cell) for cell in cells),
            ),
        )

    # -- log ----------------------------------------------------------------
    def _log(self, kind: str, **fields) -> None:
        self.log.append(Event(time=self.now, kind=kind, seq=len(self.log), **fields))

    @property
    def events_processed(self) -> int:
        """Number of records in the event log."""
        return len(self.log)

    # -- the event loop -----------------------------------------------------
    def run(self, until: Optional[float] = None) -> "SchedulerService":
        """Process pending events in deterministic ``(time, kind, seq)``
        order until the heap is empty (or past ``until``).  Returns self.

        Events within :func:`time_eps` of each other form one scheduling
        instant: the whole cluster is applied — sorted by kind rank, then
        submission sequence — before the scheduling pass runs, so a
        completion and an arrival at the "same" float time always resolve
        as completion first regardless of which float is a few ulp ahead.
        """
        while self._pending:
            t0 = self._pending[0][0]
            if until is not None and time_lt(until, t0):
                break
            if t0 > self.now:
                self.now = t0
            while True:
                batch = []
                while self._pending and time_le(self._pending[0][0], self.now):
                    batch.append(heapq.heappop(self._pending))
                if not batch:
                    break
                batch.sort(key=lambda e: (e[1], e[2]))
                # Spans only *measure* — the event application and the
                # scheduling pass are identical either way (non-perturbation
                # is pinned in tests/test_obs.py).
                if _TRACER.enabled:
                    with _TRACER.span(
                        "scheduler.step", t=self.now, events=len(batch)
                    ):
                        for _, _, _, kind, data in batch:
                            self._apply(kind, data)
                        self._schedule()
                else:
                    for _, _, _, kind, data in batch:
                        self._apply(kind, data)
                    self._schedule()
        if until is not None and until > self.now:
            self.now = until
        return self

    def result(self) -> SimulationResult:
        """Batch view of the run so far — the same
        :class:`~repro_torch.network.allocation.SimulationResult` the historical
        ``simulate_queue`` returned (``rejected`` includes backpressure
        sheds; see :attr:`shed`)."""
        return SimulationResult(
            policy=self.policy.name,
            jobs=list(self.scheduled),
            rejected=list(self.rejected),
        )

    # -- event application --------------------------------------------------
    def _apply(self, kind: str, data: tuple) -> None:
        if kind == ARRIVAL:
            request, priority, source = data
            if (
                source == "input"
                and self.max_waiting is not None
                and len(self._waiting) >= self.max_waiting
            ):
                self._log(ARRIVAL, job_id=request.job_id, request=request,
                          priority=priority, source="input")
                self._log(REJECT, job_id=request.job_id, reason="backpressure")
                self.shed.append(request.job_id)
                self.rejected.append(request.job_id)
                return
            self._enqueue(request, priority, source)
        elif kind == COMPLETE:
            job_id, gen = data
            live = self._live.get(job_id)
            if live is None or live.gen != gen:
                return  # stale: the job was evacuated/preempted meanwhile
            del self._live[job_id]
            self.machine.release(job_id)
            if self.on_release is not None:
                self.on_release(self, job_id)
            self._log(COMPLETE, job_id=job_id)
            self._blocked = None  # freed cells: the head is worth retrying
        elif kind == FAIL:
            (cells,) = data
            self._log(FAIL, cells=cells, source="input")
            mask = np.zeros(self.machine.dims, dtype=bool)
            for cell in cells:
                mask[cell] = True
            victims = sorted(
                (
                    jid
                    for jid, live in self._live.items()
                    if mask[
                        placement_cells(
                            self.machine.dims,
                            live.job.placement.oriented,
                            live.job.placement.offset,
                        )
                    ].any()
                ),
                key=lambda jid: self._live[jid].gen,
            )
            for jid in victims:
                self._evict(jid, reason="failure", requeue=True)
            for cell in cells:
                if cell not in self.failed_cells:
                    self.failed_cells.add(cell)
                    self.machine.grid[cell] = True
            self._blocked = None
        elif kind == PREEMPT:
            (job_id,) = data
            if job_id in self._live:
                self._evict(job_id, reason="external", requeue=False, source="input")
            else:
                # Nothing to suspend — log the input so replay stays faithful.
                self._log(PREEMPT, job_id=job_id, reason="not-running", source="input")
        elif kind == RECLAIM:
            job_id, cells = data
            self._log(RECLAIM, job_id=job_id, cells=cells, source="input")
            if cells:
                repaired = False
                for cell in cells:
                    if cell in self.failed_cells:
                        self.failed_cells.discard(cell)
                        self.machine.grid[cell] = False
                        repaired = True
                if repaired:
                    self._blocked = None
            if job_id is not None and job_id in self._suspended:
                request, priority = self._suspended.pop(job_id)
                self._enqueue(
                    dataclasses.replace(request, arrival=self.now),
                    priority,
                    "derived",
                )
        else:  # pragma: no cover - _push only accepts the kinds above
            raise ValueError(f"unknown event kind {kind!r}")

    def _enqueue(self, request: JobRequest, priority: int, source: str) -> None:
        queued = _Queued(request, priority, next(self._enqueue_seq))
        key = (-priority, queued.order)
        lo, hi = 0, len(self._waiting)
        while lo < hi:
            mid = (lo + hi) // 2
            w = self._waiting[mid]
            if (-w.priority, w.order) <= key:
                lo = mid + 1
            else:
                hi = mid
        self._waiting.insert(lo, queued)
        self._log(
            ARRIVAL,
            job_id=request.job_id,
            request=request,
            priority=priority,
            source="input" if source == "input" else "derived",
        )

    def _evict(
        self, job_id: int, *, reason: str, requeue: bool, source: str = "derived"
    ) -> None:
        live = self._live.pop(job_id)
        self.machine.release(job_id)
        if self.on_release is not None:
            self.on_release(self, job_id)
        remaining = max(0.0, live.job.end - self.now)
        live.job.end = self.now  # the recorded segment ends here
        request = dataclasses.replace(
            live.job.request, duration=remaining, arrival=self.now
        )
        self._log(PREEMPT, job_id=job_id, reason=reason, source=source)
        self._blocked = None
        if requeue:
            self._enqueue(request, live.priority, "derived")
        else:
            self._suspended[job_id] = (request, live.priority)

    # -- the scheduling pass ------------------------------------------------
    def _schedule(self) -> None:
        while self._waiting:
            head = self._waiting[0]
            if self._blocked is not None and self._blocked[0] == head.request.job_id:
                t_res = self._blocked[1]
            else:
                if self._try_start(head):
                    self._waiting.pop(0)
                    continue
                if self.preempt_priority and self._preempt_for(head):
                    self._waiting.pop(0)
                    continue
                prefs = self.policy.preferences_for(self.machine, head.request)
                t_res = self._reservation(prefs)
                if t_res is None:
                    self._log(
                        REJECT, job_id=head.request.job_id, reason="impossible"
                    )
                    self.rejected.append(head.request.job_id)
                    self._waiting.pop(0)
                    continue
                self._blocked = (head.request.job_id, t_res)
            if self.backfill:
                kept: List[_Queued] = []
                for queued in self._waiting[1:]:
                    if not (
                        time_le(self.now + queued.request.duration, t_res)
                        and self._try_start(queued)
                    ):
                        kept.append(queued)
                self._waiting[1:] = kept
            break

    def _try_start(self, queued: _Queued) -> bool:
        request = queued.request
        if request.job_id in self._live:
            raise ValueError(f"job {request.job_id} is already running")
        if _TRACER.enabled:
            with _TRACER.span(
                "scheduler.place", job=request.job_id, units=request.units
            ) as _sp:
                placed = self.policy.allocate(self.machine, request)
                _sp.annotate(placed=placed is not None)
        else:
            placed = self.policy.allocate(self.machine, request)
        if placed is None:
            return False
        if self.machine.is_hyperx:
            # HyperX dimensions have diameter 1, so bisection pairing never
            # contends; the geometry-sensitive benchmark is the box's
            # internal all-to-all (closed form, exact).
            pred_time = hyperx_all_to_all_max_load(self.machine.fabric.sub_fabric(placed.geometry)) / self.link_bw
        else:
            node_dims = scaled_node_dims(placed.geometry, self.unit_node_dims)
            pred_time = predict_pairing_time(node_dims, 1.0, self.link_bw).time_per_volume
        opt_bis = self._optimal_bisection(request.units)
        job = ScheduledJob(
            request=request,
            placement=placed,
            start=self.now,
            end=self.now + request.duration,
            predicted_comm_time=pred_time,
            bisection_efficiency=(
                placed.bisection_links / opt_bis if opt_bis else 1.0
            ),
        )
        gen = next(self._gen)
        self._live[request.job_id] = _Live(gen=gen, job=job, priority=queued.priority)
        if self.on_start is not None:
            self.on_start(self, job)  # may refine job.placement (measurements)
        self.scheduled.append(job)
        self._log(
            START,
            job_id=request.job_id,
            placement=job.placement,
            priority=queued.priority,
        )
        self._push(job.end, COMPLETE, (request.job_id, gen))
        return True

    def _preempt_for(self, head: _Queued) -> bool:
        """Evict strictly lower-priority running jobs (lowest priority
        first, youngest first within a level) until the head fits; jobs
        are only evicted if freeing every eligible victim would fit the
        head at all.  Returns True when the head started."""
        victims = sorted(
            (jid for jid, live in self._live.items() if live.priority < head.priority),
            key=lambda jid: (self._live[jid].priority, -self._live[jid].gen),
        )
        if not victims:
            return False
        prefs = self.policy.preferences_for(self.machine, head.request)
        scratch = self.machine.grid.clone()
        for jid in victims:
            p = self._live[jid].job.placement
            scratch[cells_index(self.machine.dims, p.oriented, p.offset, scratch.device)] = False
        if not self._fits(scratch, prefs):
            return False
        for jid in victims:
            self._evict(jid, reason="priority", requeue=True)
            if self._try_start(head):
                return True
        return False  # pragma: no cover - the scratch check guarantees a fit

    def _reservation(self, prefs: List[Geometry]) -> Optional[float]:
        """Earliest time the blocked head is guaranteed to fit: replay
        every pending free — running jobs' completions *and* scheduled
        repairs of failed cells — on a scratch grid in time order until a
        preferred geometry fits.  None: never fits, not even with every
        pending free applied — the request is impossible on the (possibly
        degraded) machine."""
        if not prefs:
            return None
        frees: List[Tuple[float, int, object]] = []
        for live in self._live.values():
            frees.append((live.job.end, live.gen, live.job.placement))
        for time, _, seq, kind, data in self._pending:
            if kind == RECLAIM and data[1]:
                frees.append((time, seq, tuple(data[1])))
        scratch = self.machine.grid.clone()
        for time, _, freed in sorted(frees, key=lambda f: (f[0], f[1])):
            if isinstance(freed, Placement):
                scratch[cells_index(self.machine.dims, freed.oriented, freed.offset, scratch.device)] = False
            else:
                for cell in freed:
                    if tuple(cell) in self.failed_cells:
                        scratch[tuple(cell)] = False
            if self._fits(scratch, prefs):
                return time
        if self._fits(scratch, prefs):
            return self.now  # defensive: only asked after a failed allocate
        return None

    @staticmethod
    def _fits(grid, prefs: List[Geometry]) -> bool:
        """Whether any preferred geometry has a free translate on ``grid``
        (every geometry searched on the device, one synchronisation)."""
        return any(spot is not None for spot in first_fits(grid, prefs))

    def _optimal_bisection(self, units: int) -> int:
        if units not in self._opt_bisection:
            try:
                self._opt_bisection[units] = best_bisection_geometry(
                    self.machine.fabric_or_dims, units, device=self.machine.device
                )[1]
            except ValueError:
                self._opt_bisection[units] = 0
        return self._opt_bisection[units]


def replay_events(
    machine_dims: Sequence[int],
    policy: AllocationPolicy,
    log: Iterable[Event],
    **service_kwargs,
) -> SchedulerService:
    """Re-drive a fresh service from the ``source == "input"`` records of
    an event log and run it to quiescence.  With the same policy and
    service options the returned service's log equals the original
    record-for-record (event-log replay determinism — pinned in tests)."""
    service = SchedulerService(machine_dims, policy, **service_kwargs)
    for event in log:
        if event.source != "input":
            continue
        if event.kind == ARRIVAL:
            service.submit(event.request, priority=event.priority)
        elif event.kind == FAIL:
            service.inject_failure(event.time, event.cells)
        elif event.kind == PREEMPT:
            service.inject_preempt(event.time, event.job_id)
        elif event.kind == RECLAIM:
            service.inject_reclaim(event.time, job_id=event.job_id, cells=event.cells)
    service.run()
    return service


def apply_monitor_failures(
    service: SchedulerService,
    monitor: HeartbeatMonitor,
    worker_cells: Dict[str, Tuple[int, ...]],
    time: Optional[float] = None,
) -> List[Tuple[int, ...]]:
    """Poll a :class:`repro_torch.runtime.fault_tolerance.HeartbeatMonitor` and
    inject a Fail event for the cells of newly-dead workers (at ``time``,
    default the service clock).  Returns the failed cells so callers can
    schedule the matching repair Reclaim once the workers rejoin."""
    cells = failure_cells(monitor, worker_cells)
    if cells:
        service.inject_failure(service.now if time is None else time, cells)
    return cells


# ---------------------------------------------------------------------------
# Scenario generation.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Scenario:
    """A reproducible workload for the service: a job stream plus timed
    failure / repair injections (see :func:`generate_scenario`)."""

    machine_dims: Tuple[int, ...]
    jobs: Tuple[JobRequest, ...]
    failures: Tuple[Tuple[float, Tuple[Coord, ...]], ...] = ()
    repairs: Tuple[Tuple[float, Tuple[Coord, ...]], ...] = ()


def _axis_divisors(extent: int) -> List[int]:
    return [d for d in range(1, extent + 1) if extent % d == 0]


def generate_scenario(
    machine_dims: Sequence[int],
    n_jobs: int,
    *,
    seed: int = 0,
    burst_gap: float = 40.0,
    burst_size: int = 6,
    tail_index: float = 1.4,
    mean_duration: float = 60.0,
    max_fraction: float = 0.25,
    failure_rate: float = 0.0,
    repair_delay: float = 200.0,
) -> Scenario:
    """Seeded synthetic workload: bursty arrivals (exponential gaps between
    bursts of ~``burst_size`` jobs), heavy-tailed job sizes (Pareto with
    ``tail_index``, snapped down to the nearest axis-divisor cuboid volume
    ≤ ``max_fraction`` of the machine), log-normal durations around
    ``mean_duration``, and optionally Poisson cell failures (rate per unit
    time) each repaired ``repair_delay`` later.  Deterministic per seed.
    """
    dims = tuple(int(d) for d in machine_dims)
    rng = np.random.default_rng(seed)
    total = int(np.prod(dims))
    cap = max(1, int(max_fraction * total))
    divisor_volumes = sorted(
        {
            int(np.prod(combo))
            for combo in itertools.product(*(_axis_divisors(d) for d in dims))
            if int(np.prod(combo)) <= cap
        }
    )
    volumes = np.asarray(divisor_volumes)

    jobs: List[JobRequest] = []
    now = 0.0
    job_id = 0
    while len(jobs) < n_jobs:
        now += float(rng.exponential(burst_gap))
        for k in range(int(rng.poisson(burst_size)) + 1):
            if len(jobs) >= n_jobs:
                break
            raw = float(rng.pareto(tail_index)) + 1.0  # Pareto >= 1
            size = int(volumes[np.searchsorted(volumes, raw, side="right") - 1])
            duration = float(
                rng.lognormal(np.log(mean_duration), 0.75)
            )
            jobs.append(
                JobRequest(
                    job_id=job_id,
                    units=size,
                    duration=duration,
                    arrival=now + 1e-3 * k,  # stable intra-burst order
                )
            )
            job_id += 1

    failures: List[Tuple[float, Tuple[Coord, ...]]] = []
    repairs: List[Tuple[float, Tuple[Coord, ...]]] = []
    if failure_rate > 0.0 and jobs:
        horizon = max(j.arrival for j in jobs)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / failure_rate))
            if t >= horizon:
                break
            cell = tuple(int(rng.integers(d)) for d in dims)
            failures.append((t, (cell,)))
            repairs.append((t + repair_delay, (cell,)))
    return Scenario(
        machine_dims=dims,
        jobs=tuple(jobs),
        failures=tuple(failures),
        repairs=tuple(repairs),
    )


def run_scenario(
    scenario: Scenario, policy: AllocationPolicy, **service_kwargs
) -> SchedulerService:
    """Drive a fresh service with a :class:`Scenario` (jobs submitted in
    arrival order, failures/repairs injected) and run it to quiescence."""
    service = SchedulerService(scenario.machine_dims, policy, **service_kwargs)
    for request in sorted(scenario.jobs, key=lambda r: (r.arrival, r.job_id)):
        service.submit(request)
    for time, cells in scenario.failures:
        service.inject_failure(time, cells)
    for time, cells in scenario.repairs:
        service.inject_reclaim(time, cells=cells)
    service.run()
    return service


def scheduler_throughput(
    scenario: Scenario, policy: AllocationPolicy, **service_kwargs
) -> Tuple[SchedulerService, float]:
    """Run a scenario and return ``(service, events_per_second)``.  Timed
    through a :class:`repro_torch.obs.Timer` (with tracing enabled the
    scenario's wall clock lands in the trace stream beside the per-event
    spans); every placement brings its winner back to the host, so the
    wall clock covers the device's work."""
    with _TRACER.timer(
        "scheduler.scenario", jobs=len(scenario.jobs), dims=scenario.machine_dims
    ) as t:
        service = run_scenario(scenario, policy, **service_kwargs)
    return service, service.events_processed / max(t.elapsed, 1e-9)
