"""Fault tolerance runtime: failure detection, restart, elastic rescale,
straggler mitigation (the port's own copy of ``repro.runtime.fault_tolerance``).

On a real multi-pod deployment these hooks sit in the coordinator process
(torch.distributed); here the mechanisms are implemented against an injectable
clock / event source so they are fully testable on one CPU:

* :class:`HeartbeatMonitor`   — per-worker heartbeats, timeout -> failed.
* :class:`StragglerTracker`   — EWMA of per-worker step times; workers
  slower than ``factor`` x median are flagged; mitigation advice is either
  "rebalance" (shrink their data shard) or "evict" (treat as failed).
* :class:`ElasticPlan`        — given alive-worker count, choose the next
  mesh (largest feasible (pods, data, model) grid) — restore-with-reshard
  does the actual state movement (checkpoint/manager.py).
* :class:`TrainingSupervisor` — ties it together around a step function:
  run steps, checkpoint periodically, on failure restore the latest commit
  and continue (optionally on a shrunk mesh).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

PyTree = Any


# ---------------------------------------------------------------------------
# Failure detection
# ---------------------------------------------------------------------------
class HeartbeatMonitor:
    def __init__(self, workers: List[str], timeout: float, clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.last_seen: Dict[str, float] = {w: now for w in workers}
        self.failed: set = set()

    def beat(self, worker: str) -> None:
        if worker in self.failed:
            return  # a failed worker must rejoin via `rejoin`
        self.last_seen[worker] = self.clock()

    def rejoin(self, worker: str) -> None:
        self.failed.discard(worker)
        self.last_seen[worker] = self.clock()

    def check(self) -> List[str]:
        """Returns newly-failed workers."""
        now = self.clock()
        newly = [
            w
            for w, t in self.last_seen.items()
            if w not in self.failed and now - t > self.timeout
        ]
        self.failed.update(newly)
        return newly

    @property
    def alive(self) -> List[str]:
        return [w for w in self.last_seen if w not in self.failed]


def failure_cells(
    monitor: HeartbeatMonitor, worker_cells: Dict[str, Tuple[int, ...]]
) -> List[Tuple[int, ...]]:
    """Torus cells of the workers ``monitor.check()`` newly declares dead:
    the glue between heartbeat detection and the network scheduler
    (:func:`repro_torch.network.scheduler.apply_monitor_failures`), which
    evacuates and requeues the jobs on them and keeps the cells out of the
    free pool until a ``Reclaim`` repairs them.  Workers without a cell
    assignment (e.g. spares) are skipped."""
    return [tuple(worker_cells[w]) for w in monitor.check() if w in worker_cells]


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------
@dataclass
class StragglerTracker:
    alpha: float = 0.3  # EWMA coefficient
    factor: float = 1.5  # flag threshold vs median
    evict_factor: float = 3.0
    ewma: Dict[str, float] = field(default_factory=dict)

    def record(self, worker: str, step_time: float) -> None:
        prev = self.ewma.get(worker)
        self.ewma[worker] = (
            step_time if prev is None else self.alpha * step_time + (1 - self.alpha) * prev
        )

    def median(self) -> float:
        """Lower median — robust when up to half the fleet is slow."""
        vals = sorted(self.ewma.values())
        if not vals:
            return 0.0
        return vals[(len(vals) - 1) // 2]

    def stragglers(self) -> Dict[str, str]:
        """worker -> advice ('rebalance' | 'evict')."""
        med = self.median()
        out = {}
        if med <= 0:
            return out
        for w, t in self.ewma.items():
            if t > self.evict_factor * med:
                out[w] = "evict"
            elif t > self.factor * med:
                out[w] = "rebalance"
        return out

    def rebalanced_shares(self, workers: List[str]) -> Dict[str, float]:
        """Data shares inversely proportional to speed (sum to 1)."""
        inv = {w: 1.0 / self.ewma.get(w, self.median() or 1.0) for w in workers}
        total = sum(inv.values())
        return {w: v / total for w, v in inv.items()}


# ---------------------------------------------------------------------------
# Elastic rescale planning
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ElasticPlan:
    pods: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


def plan_mesh(alive_chips: int, model_parallel: int, pod_size: int = 256) -> ElasticPlan:
    """Largest (pods, data, model) grid fitting the alive chip count.

    Keeps model-parallel degree fixed (weights layouts stay valid) and
    shrinks data parallelism — the standard elastic policy.
    """
    if alive_chips < model_parallel:
        raise ValueError("fewer chips than the model-parallel degree")
    pods = max(1, alive_chips // pod_size)
    while pods > 1:
        per_pod = alive_chips // pods
        if per_pod * pods >= model_parallel and per_pod % model_parallel == 0:
            break
        pods -= 1
    per_pod = alive_chips // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError("cannot fit the model-parallel degree per pod")
    return ElasticPlan(pods=pods, data=data, model=model_parallel)


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------
@dataclass
class SupervisorReport:
    steps_run: int = 0
    failures_handled: int = 0
    restores: int = 0
    evictions: List[str] = field(default_factory=list)
    final_step: int = 0


class TrainingSupervisor:
    """Runs a (state, step) -> state step function under fault injection.

    ``step_fn(state, step_idx)`` must be pure on its inputs;
    ``save_fn(step, state)`` / ``restore_fn() -> (step, state)`` wrap the
    CheckpointManager.  ``failure_schedule`` maps step index -> list of
    workers that die right before that step (test injection).
    """

    def __init__(
        self,
        step_fn: Callable[[PyTree, int], PyTree],
        save_fn: Callable[[int, PyTree], None],
        restore_fn: Callable[[], Tuple[int, PyTree]],
        monitor: HeartbeatMonitor,
        checkpoint_every: int = 10,
        failure_schedule: Optional[Dict[int, List[str]]] = None,
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.monitor = monitor
        self.checkpoint_every = checkpoint_every
        self.failure_schedule = failure_schedule or {}

    def run(self, state: PyTree, start_step: int, num_steps: int) -> Tuple[PyTree, SupervisorReport]:
        report = SupervisorReport()
        step = start_step
        end = start_step + num_steps
        while step < end:
            # injected failures: workers stop heartbeating
            for w in self.failure_schedule.get(step, []):
                self.monitor.last_seen[w] = -math.inf
            newly_failed = self.monitor.check()
            if newly_failed:
                report.failures_handled += len(newly_failed)
                report.evictions.extend(newly_failed)
                # restart from the last committed checkpoint
                step, state = self.restore_fn()
                report.restores += 1
                continue
            state = self.step_fn(state, step)
            step += 1
            report.steps_run += 1
            if step % self.checkpoint_every == 0:
                self.save_fn(step, state)
        report.final_step = step
        return state, report
