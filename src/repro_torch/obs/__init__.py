"""Telemetry of the port (counterpart of ``repro.obs``): tracing, metrics,
contention attribution and the network passes' dispatch counts.

* :mod:`repro_torch.obs.trace` — the span tracer (off by default; a span
  is a ``torch.profiler`` range while a profiler is active, and a shared
  no-op while neither is on), wall-clock timers, Chrome trace-event export,
  and :data:`DISPATCHES`, the count of each network pass's calls per
  device type.
* :mod:`repro_torch.obs.metrics` — counters, gauges and histograms with
  labeled series and JSON snapshots; :func:`scheduler_metrics` derives the
  scheduler's metrics from its event log, so a replayed log gives the same
  snapshot exactly.
* :mod:`repro_torch.obs.contention` — per-link load attribution by owning
  job (self and cross traffic), hotspot links and the avoidable-contention
  gauge, computed on the machine's device.

>>> tracing_enabled()
False
>>> with trace("noop"):
...     pass
>>> export_chrome_trace()["traceEvents"]
[]
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs.trace import DISPATCHES, TRACER, Span, Timer, Tracer, count_dispatch
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    scheduler_metrics,
)
from repro_torch.obs.contention import (
    ContentionReport,
    HotspotLink,
    JobContention,
    attribute_contention,
    attribute_traffic,
    render_dashboard,
)

__all__ = [
    "DISPATCHES",
    "TRACER",
    "ContentionReport",
    "Counter",
    "Gauge",
    "Histogram",
    "HotspotLink",
    "JobContention",
    "MetricsRegistry",
    "Span",
    "Timer",
    "Tracer",
    "attribute_contention",
    "attribute_traffic",
    "count_dispatch",
    "disable_tracing",
    "enable_tracing",
    "export_chrome_trace",
    "render_dashboard",
    "scheduler_metrics",
    "timer",
    "trace",
    "tracing_enabled",
]


def enable_tracing(clear: bool = False) -> None:
    """Turn the process-wide tracer on (``clear=True`` drops prior events)."""
    TRACER.enable(clear=clear)


def disable_tracing() -> None:
    """Turn the process-wide tracer off (events are kept)."""
    TRACER.disable()


def tracing_enabled() -> bool:
    """Whether the process-wide tracer is recording."""
    return TRACER.enabled


def trace(name: str, **args: Any):
    """Open a span on the process-wide tracer: recorded while tracing is
    on, a ``torch.profiler`` range while a profiler is active, else a
    shared no-op (:meth:`Tracer.span`)."""
    return TRACER.span(name, **args)


def timer(name: str, **args: Any) -> Timer:
    """An always-measuring :class:`Timer` on the process-wide tracer."""
    return TRACER.timer(name, **args)


def export_chrome_trace(path: Optional[str] = None) -> Dict[str, Any]:
    """The process-wide tracer's Chrome trace object (written to ``path``
    when given)."""
    return TRACER.export(path)
