"""The traced window: ``torch.profiler`` over the measured loop, and its
reduction to device busy time, time by kernel and idle gaps.

Device operations are the profiler's kernels, copies and fills; each is
clipped to the window, which is the harness's own ``chipbench.window``
range.  Busy time is the union of their intervals.  An idle gap is a stretch
of the window with no device operation; it is named by what the host was
doing at its middle: the innermost host operation or range open there
(the CUDA runtime call only where no other is open), else ``host: none``.
Gaps under ``SHORT_NS`` (the launch gaps between back-to-back kernels) are
summed under one name, and only the ``NAMED`` longest are named, so the
reduction stays linear in the events.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "chipbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list
SHORT_NS = 10_000
NAMED = 2000


@dataclass
class Trace:
    window_s: float
    busy_s: float
    by_op: Dict[str, float] = field(default_factory=dict)  # device seconds by operation name
    gaps: Dict[str, float] = field(default_factory=dict)  # idle seconds by host activity

    def seconds_of(self, names: Iterable[str]) -> float:
        """Device seconds of the operations whose name contains one of ``names``."""
        names = tuple(names)
        return sum(s for op, s in self.by_op.items() if any(n in op for n in names))

    def breakdown(self) -> dict:
        ops: Dict[str, float] = {}
        for name, s in self.by_op.items():
            ops[short_name(name)] = ops.get(short_name(name), 0.0) + s
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(self.gaps)}


_TIDY = [
    (r"\(anonymous namespace\)::|at::native::|at::|c10::", ""),
    (r"\(TensorIteratorBase&\)|::operator\(\)\(\) const", ""),
    (r"\{lambda\(\)#\d+\}(::)?", ""),
    (r"\{lambda\(([^)]*)\)#\d+\}", r"\1"),
    (r"std::array<char\*, \d+ul>|TrivialOffsetCalculator<[^>]*>|memory::\w+<\d+>", ""),
    (r"\s+", " "),
    (r"(, ?)+(?=[,>])|::(?=[,>])", ""),
]


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its argument list, return type, namespaces
    and lambda scaffolding, at most ``limit`` characters: enough to tell
    PyTorch's elementwise kernels apart by functor and type."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            cut = i
            break
    out = name[:cut]
    for pattern, repl in _TIDY:
        out = re.sub(pattern, repl, out)
    return out.strip()[:limit]


@contextlib.contextmanager
def traced(device: torch.device, on: bool):
    """Yields a function that returns the window's :class:`Trace` once the
    block has ended (None when ``on`` is false)."""
    if not on:
        yield lambda: None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    box: List[Optional[Trace]] = [None]
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield lambda: box[0]
    box[0] = reduce(prof.profiler.kineto_results.events())


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def kind_of(e) -> str:
    """The event's activity type as kineto names it ("kernel", "gpu_memcpy",
    "user_annotation", "cuda_runtime", "cpu_op", ...).  torch's events do
    not carry it, so it is told from the device, the annotation flag and
    the names of copies, fills and runtime calls."""
    name, annotation = e.name(), e.is_user_annotation()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if annotation:
            return "gpu_user_annotation"
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) and "::" not in name else "cpu_op"


def reduce(events) -> Trace:
    window = None
    device, host = [], []
    for e in events:
        kind, name = kind_of(e), e.name()
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if name == WINDOW and kind == "user_annotation":
            window = span
        elif kind in DEVICE_KINDS:
            device.append((span, name))
        elif not kind.startswith("gpu_"):
            host.append((span, name, kind))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    lo, hi = window
    by_op: Dict[str, float] = {}
    spans = []
    for (a, b), name in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-9
            spans.append((a, b))
    busy = _union(spans)
    edges = [lo] + [x for s in busy for x in s] + [hi]
    idle = sorted(((b - a, a) for a, b in zip(edges[::2], edges[1::2]) if b > a), reverse=True)
    long_ = [g for g in idle[:NAMED] if g[0] >= SHORT_NS]
    short = sum(g[0] for g in idle) - sum(g[0] for g in long_)
    gaps: Dict[str, float] = {f"host: short gaps (< {SHORT_NS // 1000} us each)": short * 1e-9} if short else {}
    host = [h for h in host if h[1] != WINDOW]
    starts = np.array([a for (a, _), _, _ in host], dtype=np.int64)
    ends = np.array([b for (_, b), _, _ in host], dtype=np.int64)
    runtime = np.array([k == "cuda_runtime" for _, _, k in host], dtype=bool)
    for length, a in long_:
        label = _host_at(a + length // 2, host, starts, ends, runtime)
        gaps[label] = gaps.get(label, 0.0) + length * 1e-9
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=sum(b - a for a, b in busy) * 1e-9,
                 by_op=by_op, gaps=gaps)


def _host_at(t: int, host, starts, ends, runtime) -> str:
    """The innermost (shortest) host range open at ``t``, preferring one that
    is no CUDA runtime call."""
    open_ = (starts <= t) & (ends > t)
    for pick in (open_ & ~runtime, open_):
        idx = np.flatnonzero(pick)
        if idx.size:
            return f"host: {host[idx[np.argmin(ends[idx] - starts[idx])]][1]}"
    return "host: none"
