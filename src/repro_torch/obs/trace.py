"""The span tracer, wall-clock timers and the network passes' dispatch
counts (counterpart of ``repro.obs.trace``).

The tracer is the port's own copy of ``repro.obs.trace``: one process-wide
:class:`Tracer` (:data:`TRACER`) records named wall-clock spans with
key/value annotations, exported as Chrome trace-event JSON (``"X"``
complete events, loadable in Perfetto).  Tracing is off by default; the
disabled path is one attribute check, and enabling it never changes a
result.  The allocation engines emit ``placement.search``,
``scheduler.step``, ``scheduler.place`` and ``scheduler.scenario``.

PyTorch queues CUDA work asynchronously, so a caller timing card work
runs ``torch.cuda.synchronize()`` (``repro_torch.device.synchronize``)
inside the ``with`` block, where the JAX launcher calls
``block_until_ready``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional

__all__ = ["DISPATCHES", "Span", "TRACER", "Timer", "Tracer", "count_dispatch"]

#: Calls of each pass of ``repro_torch.network``, keyed by (pass, device
#: type) — the counterpart of the JAX package's ``backend.dispatches``
#: counter.  It has no jit-compile counter: eager torch compiles nothing
#: per shape.
DISPATCHES: Counter = Counter()


def count_dispatch(name: str, device_type: str) -> None:
    """Count one call of the network pass ``name`` on ``device_type``."""
    DISPATCHES[(name, device_type)] += 1


class Span:
    """One live span: a named interval opened by :meth:`Tracer.span`.

    Use as a context manager; :meth:`annotate` attaches key/value pairs
    and :meth:`incr` accumulates additive counters — both land in the
    exported event's ``args``."""

    __slots__ = ("name", "args", "tid", "_tracer", "_t0", "duration")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.tid = threading.get_ident()
        self._t0 = 0
        self.duration = 0.0  # seconds, set at exit

    def annotate(self, **kv: Any) -> "Span":
        """Attach key/value annotations to the span."""
        self.args.update(kv)
        return self

    def incr(self, key: str, n: float = 1) -> "Span":
        """Accumulate an additive counter in the span's args."""
        self.args[key] = self.args.get(key, 0) + n
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        self.duration = (t1 - self._t0) * 1e-9
        self._tracer._record(self, self._t0, t1)
        return False


class _NoopSpan:
    """Shared disabled-path span: every method is a cheap no-op."""

    __slots__ = ()
    name = ""
    args: Dict[str, Any] = {}
    duration = 0.0

    def annotate(self, **kv: Any) -> "_NoopSpan":
        return self

    def incr(self, key: str, n: float = 1) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


class Timer:
    """Always-measuring wall-clock context manager (``obs.timer``):
    ``elapsed`` holds seconds, and with tracing enabled the interval is
    also recorded as a span."""

    __slots__ = ("name", "args", "elapsed", "_tracer", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.elapsed = 0.0
        self._t0 = 0

    def annotate(self, **kv: Any) -> "Timer":
        """Attach key/value annotations (recorded when tracing is on)."""
        self.args.update(kv)
        return self

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        self.elapsed = (t1 - self._t0) * 1e-9
        if self._tracer.enabled:
            span = Span(self._tracer, self.name, self.args)
            span.duration = self.elapsed
            self._tracer._record(span, self._t0, t1)
        return False


class Tracer:
    """Thread-safe span recorder exporting Chrome trace-event JSON.

    ``enabled`` is a plain attribute — the single check the disabled
    path pays.  Finished spans append under a lock as ``"X"`` events
    with microsecond ``ts``/``dur`` relative to the tracer's epoch."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._epoch = time.perf_counter_ns()

    def enable(self, clear: bool = False) -> None:
        """Turn tracing on (optionally clearing recorded events first)."""
        if clear:
            self.clear()
        self.enabled = True

    def disable(self) -> None:
        """Turn tracing off; recorded events are kept until :meth:`clear`."""
        self.enabled = False

    def clear(self) -> None:
        """Drop all recorded events and reset the time epoch."""
        with self._lock:
            self._events = []
            self._epoch = time.perf_counter_ns()

    def span(self, name: str, **args: Any):
        """Open a span (context manager); a shared no-op while disabled."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, args)

    def timer(self, name: str, **args: Any) -> Timer:
        """An always-measuring :class:`Timer` (span recorded only when
        tracing is enabled)."""
        return Timer(self, name, args)

    def _record(self, span: Span, t0_ns: int, t1_ns: int) -> None:
        event = {
            "name": span.name,
            "ph": "X",
            "ts": (t0_ns - self._epoch) * 1e-3,  # microseconds
            "dur": (t1_ns - t0_ns) * 1e-3,
            "pid": os.getpid(),
            "tid": span.tid,
        }
        if span.args:
            event["args"] = dict(span.args)
        with self._lock:
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the recorded trace events (copies)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (``traceEvents`` sorted by
        start time, parents before their children)."""
        events = self.events()
        events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Return the Chrome trace object, writing it to ``path`` (JSON)
        when given."""
        trace = self.chrome_trace()
        if path is not None:
            with open(path, "w") as fh:
                json.dump(trace, fh, indent=1)
        return trace


#: The process-wide tracer every instrumented module records into.
TRACER = Tracer()
