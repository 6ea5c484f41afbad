"""Wall-clock timers for the launchers (counterpart of ``repro.obs.timer``).

A copy of the part of ``repro.obs.trace.Timer`` that the serving driver
uses: an always-measuring context manager whose ``elapsed`` holds seconds.
PyTorch queues CUDA work asynchronously, so the caller runs
``torch.cuda.synchronize()`` (``repro_torch.device.synchronize``) inside
the ``with`` block, where the JAX driver calls ``block_until_ready``.
"""

from __future__ import annotations

import time
from typing import Any, Dict


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
