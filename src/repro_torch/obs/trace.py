"""The span tracer, wall-clock timers and the network passes' dispatch
counts (counterpart of ``repro.obs.trace``).

The tracer is the port's own copy of ``repro.obs.trace``: one process-wide
:class:`Tracer` (:data:`TRACER`) records named wall-clock spans with
key/value annotations, exported as Chrome trace-event JSON (``"X"``
complete events, loadable in Perfetto).  Tracing is off by default, and
enabling it never changes a result.  The allocation engines emit
``placement.search``, ``scheduler.step``, ``scheduler.place`` and
``scheduler.scenario``; the transformer's layers emit ``model.*`` and the
train step ``train.*`` (``obs.trace``).

A span also opens a ``torch.profiler.record_function`` range of its name
while a torch profiler is active, so it sits in the profiler's own
timeline (on the thread that opened it: the autograd engine's, for a
layer recomputed in the backward pass), whether or not the tracer records.
With neither on, :meth:`Tracer.span` returns a shared no-op: two flag
checks.  Spans are stamped on the clock the profiler's events carry
(``time.time_ns``, the Unix clock), so an exported trace lines up with a
profiler trace of the same run with no offset; a :class:`Timer` measures
its ``elapsed`` on the monotonic clock.

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

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

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

    Use as a context manager; :meth:`annotate` attaches key/value pairs,
    which land in the exported event's ``args``.  ``tracer`` is None for a
    span that only opens a profiler range (the tracer off, a profiler
    active)."""

    __slots__ = ("name", "args", "tid", "_tracer", "_range", "_t0", "duration")

    def __init__(self, tracer: Optional["Tracer"], name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.tid = threading.get_ident()
        self._range = None
        self._t0 = 0
        self.duration = 0.0  # seconds, set at exit

    def annotate(self, **kv: Any) -> "Span":
        """Attach key/value annotations to the span."""
        self.args.update(kv)
        return self

    def __enter__(self) -> "Span":
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.time_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self.duration = (t1 - self._t0) * 1e-9
        if self._tracer is not None:
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

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


class Timer:
    """Always-measuring wall-clock context manager (``obs.timer``):
    ``elapsed`` holds seconds on the monotonic clock, and with tracing
    enabled the interval is also recorded as a span (stamped on the
    profiler's clock)."""

    __slots__ = ("name", "args", "elapsed", "_tracer", "_t0", "_stamp")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.elapsed = 0.0
        self._t0 = self._stamp = 0

    def annotate(self, **kv: Any) -> "Timer":
        """Attach key/value annotations (recorded when tracing is on)."""
        self.args.update(kv)
        return self

    def __enter__(self) -> "Timer":
        self._stamp = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        self.elapsed = (t1 - self._t0) * 1e-9
        if self._tracer.enabled:
            span = Span(self._tracer, self.name, self.args)
            span.duration = self.elapsed
            self._tracer._record(span, self._stamp, self._stamp + t1 - self._t0)
        return False


class Tracer:
    """Thread-safe span recorder exporting Chrome trace-event JSON.

    ``enabled`` is a plain attribute, checked before the profiler's flag
    on the disabled path.  Finished spans append under a lock as ``"X"``
    events with microsecond ``ts``/``dur``; ``ts`` is on the Unix clock,
    as the profiler's event times are (``start_ns() / 1e3``)."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []

    def enable(self, clear: bool = False) -> None:
        """Turn tracing on (optionally clearing recorded events first)."""
        if clear:
            self.clear()
        self.enabled = True

    def disable(self) -> None:
        """Turn tracing off; recorded events are kept until :meth:`clear`."""
        self.enabled = False

    def clear(self) -> None:
        """Drop all recorded events."""
        with self._lock:
            self._events = []

    def span(self, name: str, **args: Any):
        """Open a span (context manager): recorded while enabled, a profiler
        range while a torch profiler is active, else a shared no-op."""
        if self.enabled:
            return Span(self, name, args)
        if _profiler_enabled():
            return Span(None, name, args)
        return _NOOP

    def timer(self, name: str, **args: Any) -> Timer:
        """An always-measuring :class:`Timer` (span recorded only when
        tracing is enabled)."""
        return Timer(self, name, args)

    def _record(self, span: Span, t0_ns: int, t1_ns: int) -> None:
        event = {
            "name": span.name,
            "ph": "X",
            "ts": t0_ns * 1e-3,  # microseconds on the Unix clock
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
