"""Metrics registry: counters, gauges, histograms with labeled series.

A :class:`MetricsRegistry` holds named instruments, each a family of
*labeled series* (``name{job=3}`` style), and snapshots to plain JSON.
The scheduler's metrics are not sampled inline — they are **derived from
the event log** by :func:`scheduler_metrics`, so replaying a log through
a fresh service (:func:`repro_torch.network.scheduler.replay_events`)
reproduces every metric exactly, bit-for-bit.  Host-side Python, the
port's copy of ``repro.obs.metrics``.

>>> reg = MetricsRegistry()
>>> reg.counter("events", kind="arrival").incr(3)
>>> reg.gauge("depth").set(2.0)
>>> h = reg.histogram("wait")
>>> h.observe(0.5); h.observe(12.0)
>>> snap = reg.snapshot()
>>> snap["counters"]["events{kind=arrival}"]
3
>>> snap["histograms"]["wait"]["count"]
2
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "scheduler_metrics",
]

#: Default histogram bucket upper bounds (log-spaced decades with 1-3
#: subdivision; +inf is implicit).
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(-3, 5) for m in (1.0, 3.0)
)


def _series_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def incr(self, n: float = 1) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError("counters only increase; use a gauge")
        self.value += n


class Gauge:
    """Point-in-time value (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        """Set the gauge to ``v`` (stored as given — exactness matters
        for the per-job efficiency gauges)."""
        self.value = v


class Histogram:
    """Cumulative-bucket histogram with exact count/sum/min/max.

    ``buckets`` are upper bounds (``le``); an implicit +inf bucket
    catches the overflow.  ``observe`` is exact on the summary stats —
    only the distribution is quantised."""

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        """Record one observation."""
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        lo, hi = 0, len(self.buckets)
        while lo < hi:  # first bucket with bound >= v
            mid = (lo + hi) // 2
            if self.buckets[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }
        nonzero = {}
        for bound, c in zip(self.buckets + (math.inf,), self.counts):
            if c:
                nonzero[f"{bound:g}"] = c
        out["buckets"] = nonzero
        return out


class MetricsRegistry:
    """Thread-safe registry of labeled counter/gauge/histogram series.

    Instruments are created on first touch; the same ``(name, labels)``
    pair always returns the same series.  :meth:`snapshot` renders the
    whole registry to a plain JSON-able dict."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, **labels: Any) -> Counter:
        """The counter series for ``(name, labels)`` (created on first use)."""
        key = _series_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        """The gauge series for ``(name, labels)`` (created on first use)."""
        key = _series_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
        return g

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS, **labels: Any
    ) -> Histogram:
        """The histogram series for ``(name, labels)`` (created on first
        use; ``buckets`` only applies at creation)."""
        key = _series_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(buckets)
        return h

    def clear(self) -> None:
        """Drop every series."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: ``{"counters": .., "gauges": .., "histograms": ..}``."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
                "histograms": {
                    k: h.to_dict() for k, h in sorted(self._histograms.items())
                },
            }

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Snapshot, optionally written to ``path`` as JSON."""
        snap = self.snapshot()
        if path is not None:
            with open(path, "w") as fh:
                json.dump(snap, fh, indent=1)
        return snap


# ---------------------------------------------------------------------------
# Scheduler metrics — derived from the event log, never sampled inline.
# ---------------------------------------------------------------------------
def scheduler_metrics(service, registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Derive a :class:`SchedulerService`'s metrics from its event log.

    Populates (into ``registry``, default a fresh one):

    * ``scheduler.events{kind=..}`` counters, plus ``scheduler.preemptions``,
      ``scheduler.backpressure_sheds``, ``scheduler.rejections``;
    * ``scheduler.queue_depth`` histogram (sampled at every log record)
      and ``scheduler.queue_depth_max`` gauge — reconstructed by walking
      arrivals/starts/rejects in log order;
    * ``scheduler.wait_time`` / ``scheduler.turnaround`` histograms
      (start - arrival, completion - first arrival per job);
    * ``scheduler.utilization`` gauge — busy cell-time over total
      cell-time across the log horizon;
    * per-job ``scheduler.job.bisection_efficiency{job=..}`` and
      ``scheduler.job.simulated_slowdown{job=..}`` gauges, **exactly**
      the values on the service's :class:`ScheduledJob` records (so the
      snapshot matches ``service.result()`` bit-for-bit).

    Everything is a pure function of the log plus the scheduled-job
    table, both of which replay deterministically — so metrics from a
    replayed service equal the original's snapshot exactly.
    """
    reg = registry if registry is not None else MetricsRegistry()
    log = service.log

    depth = 0
    depth_max = 0
    waiting_since: Dict[int, float] = {}
    first_arrival: Dict[int, float] = {}
    depth_hist = reg.histogram("scheduler.queue_depth")
    wait_hist = reg.histogram("scheduler.wait_time")
    turn_hist = reg.histogram("scheduler.turnaround")
    for event in log:
        reg.counter("scheduler.events", kind=event.kind).incr()
        if event.kind == "arrival":
            waiting_since[event.job_id] = event.time
            first_arrival.setdefault(event.job_id, event.time)
            depth += 1
        elif event.kind == "start":
            t_arr = waiting_since.pop(event.job_id, event.time)
            wait_hist.observe(event.time - t_arr)
            depth -= 1
        elif event.kind == "reject":
            if event.job_id in waiting_since:
                del waiting_since[event.job_id]
                depth -= 1
            reg.counter("scheduler.rejections", reason=event.reason or "").incr()
            if event.reason == "backpressure":
                reg.counter("scheduler.backpressure_sheds").incr()
        elif event.kind == "complete":
            t0 = first_arrival.get(event.job_id)
            if t0 is not None:
                turn_hist.observe(event.time - t0)
        elif event.kind == "preempt":
            reg.counter("scheduler.preemptions", reason=event.reason or "").incr()
        if depth > depth_max:
            depth_max = depth
        depth_hist.observe(depth)
    reg.gauge("scheduler.queue_depth").set(float(depth))
    reg.gauge("scheduler.queue_depth_max").set(float(depth_max))

    # Utilization: busy cell-time over the log horizon (committed segments
    # are clipped to the horizon; an empty log reads 0).
    horizon = log[-1].time if log else 0.0
    total_cells = 1
    for a in service.machine.dims:
        total_cells *= int(a)
    busy = 0.0
    for job in service.scheduled:
        units = math.prod(int(w) for w in job.placement.oriented)
        busy += max(0.0, min(job.end, horizon) - job.start) * units
    denom = total_cells * horizon
    reg.gauge("scheduler.utilization").set(busy / denom if denom > 0 else 0.0)

    for job in service.scheduled:
        jid = job.request.job_id
        reg.gauge("scheduler.job.bisection_efficiency", job=jid).set(
            job.bisection_efficiency
        )
        reg.gauge("scheduler.job.simulated_slowdown", job=jid).set(
            job.simulated_slowdown
        )
    return reg
