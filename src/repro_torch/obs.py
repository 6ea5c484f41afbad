"""Wall-clock timers for the launchers (counterpart of ``repro.obs.timer``)
and the network passes' dispatch counts (``backend.dispatches``).

A copy of the part of ``repro.obs.trace.Timer`` that the serving driver
uses: an always-measuring context manager whose ``elapsed`` holds seconds.
PyTorch queues CUDA work asynchronously, so the caller runs
``torch.cuda.synchronize()`` (``repro_torch.device.synchronize``) inside
the ``with`` block, where the JAX driver calls ``block_until_ready``.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Dict

#: Calls of each pass of ``repro_torch.network.backend``, keyed by (pass,
#: device type) — the counterpart of the JAX package's
#: ``backend.dispatches`` counter.  It has no jit-compile counter: eager
#: torch compiles nothing per shape.
DISPATCHES: Counter = Counter()


def count_dispatch(name: str, device_type: str) -> None:
    """Count one call of the network pass ``name`` on ``device_type``."""
    DISPATCHES[(name, device_type)] += 1


class Timer:
    """Always-measuring wall-clock context manager (``obs.timer``)."""

    __slots__ = ("name", "args", "elapsed", "_t0")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self.elapsed = 0.0
        self._t0 = 0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.elapsed = (time.perf_counter_ns() - self._t0) * 1e-9
        return False


def timer(name: str, **args: Any) -> Timer:
    """An always-measuring :class:`Timer`."""
    return Timer(name, args)
