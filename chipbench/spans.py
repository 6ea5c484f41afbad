"""Device time by program span: each device operation of the traced window
charged to the span of the program (``repro_torch.obs.trace``'s
``model.*`` and ``train.*`` ranges) that launched it.

* **Forward work.**  A device operation is tied to the host event that
  launched it: its ``linked_correlation_id()`` is the ``correlation_id()``
  of the innermost op or range open at the launch, or, where that names no
  event, its own ``correlation_id()`` is the runtime call's.  It is charged
  to the innermost program range open on that event's thread at its start
  (program ranges are user annotations not named ``chipbench.*``).  A
  ``model.*`` range opened while ``train.backward`` is open (block remat's
  recompute, on the autograd engine's thread) is charged as
  ``recompute/<span>``.
* **Backward work.**  An operation whose innermost open range or backward
  node is an autograd node (``autograd::engine::evaluate_function: ...``,
  with its ``sequence_nr()`` and ``fwd_thread_id()``) is charged to
  ``backward/<span>``, where ``<span>`` is the innermost program range open
  at the forward op of that sequence number on that thread (the last op
  with the number to start: ops carry the number of the next node made on
  their thread, so the last is the op that made it, or one inside it).
* **Leftovers** go to the innermost ``chipbench.*`` range, or to ``none``:
  so does an operation whose event carries no correlation fields.

Seconds are clipped to the window (the harness's ``chipbench.window``
range), as ``chipbench.trace.reduce`` clips them, and summed, not united.
``METRICS`` names the per-layer readings made from them: device
milliseconds per finished unit (batch or step).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

from chipbench.trace import DEVICE_KINDS, WINDOW, kind_of

BACKWARD = "autograd::engine::evaluate_function: "
HARNESS = "chipbench."
RECOMPUTE, GRADIENT = "recompute/", "backward/"

# Each metric: the spans whose device time it sums (a name ending in "/" is
# a prefix: every span under it).
METRICS: Dict[str, Tuple[str, ...]] = {
    "attention_ms.score": ("model.attention",),
    "rope_ms.score": ("model.rope",),
    "norm_ms.score": ("model.norm",),
    "mlp_ms.score": ("model.mlp",),
    "head_ms.score": ("model.head",),
    "attention_ms.train": ("model.attention", RECOMPUTE + "model.attention", GRADIENT + "model.attention"),
    "recompute_ms.train": (RECOMPUTE,),
    "optimizer_ms.train": ("train.optimizer",),
}


def _field(e, name: str, default):
    get = getattr(e, name, None)
    return get() if get is not None else default


def _stacks(intervals, queries):
    """For each query ``(thread, t, key)``, the ranges open on its thread at
    ``t``, outermost first, as a tuple of interval payloads.  Ranges of one
    thread nest (they are record functions), so one sweep per thread with a
    stack finds them; a range that opens at ``t`` counts as open."""
    by_thread = defaultdict(list)
    for tid, a, b, payload in intervals:
        by_thread[tid].append((a, 0, -b, payload))
    for tid, t, key in queries:
        by_thread[tid].append((t, 1, 0, key))
    out = {}
    for items in by_thread.values():
        items.sort(key=lambda x: x[:3])
        stack = []
        for t, is_query, neg_end, payload in items:
            while stack and stack[-1][0] <= t:
                stack.pop()
            if is_query:
                out[payload] = tuple(p for _, p in stack)
            else:
                stack.append((-neg_end, payload))
    return out


def _innermost(stack, program_only: bool = False):
    """The innermost entry of ``stack`` that is a program range or (unless
    ``program_only``) a backward node, else the innermost harness range,
    else None."""
    for kind, *rest in reversed(stack):
        if kind == "program" or (kind == "backward" and not program_only):
            return (kind, *rest)
    for kind, *rest in reversed(stack):
        if kind == "harness":
            return (kind, *rest)
    return None


def by_span(events: Iterable) -> Dict[str, float]:
    """Device seconds in the window by program span (see the module's
    note)."""
    window = None
    device, ranges, launchers, runtime, forward_ops = [], [], {}, {}, {}
    backward_open = []
    for e in events:
        kind, name = kind_of(e), e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if kind in DEVICE_KINDS:
            device.append((a, b, _field(e, "linked_correlation_id", 0), _field(e, "correlation_id", 0)))
            continue
        if kind.startswith("gpu_"):
            continue
        if name == WINDOW and kind == "user_annotation":
            window = (a, b)
            continue
        tid = _field(e, "start_thread_id", 0)
        corr = _field(e, "correlation_id", 0)
        if corr > 0 and _field(e, "linked_correlation_id", 0) == 0:
            launchers[corr] = (tid, a)
        if kind == "cuda_runtime" and corr > 0:
            runtime[corr] = (tid, a)
        if kind == "user_annotation":
            ranges.append((tid, a, b, ("harness" if name.startswith(HARNESS) else "program", name)))
            if name == "train.backward":
                backward_open.append((a, b))
        elif name.startswith(BACKWARD):
            ranges.append((tid, a, b, ("backward", _field(e, "sequence_nr", -1), _field(e, "fwd_thread_id", 0))))
        elif _field(e, "sequence_nr", -1) >= 0 and _field(e, "fwd_thread_id", 0) == 0:
            # Every op through autograd's key carries the next node's number;
            # the last to start is the one that made the node (or inside it).
            key = (tid, e.sequence_nr())
            forward_ops[key] = max(a, forward_ops.get(key, a))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    lo, hi = window

    queries = [(tid, t, ("launch", corr)) for corr, (tid, t) in launchers.items()]
    queries += [(tid, t, ("runtime", corr)) for corr, (tid, t) in runtime.items()]
    launch_stacks = _stacks(ranges, queries)
    wanted = set()
    for stack in launch_stacks.values():
        top = _innermost(stack)
        if top is not None and top[0] == "backward" and top[1] >= 0:
            wanted.add((top[2], top[1]))
    fwd_queries = [(tid, forward_ops[(tid, seq)], ("forward", tid, seq))
                   for tid, seq in wanted if (tid, seq) in forward_ops]
    forward_stacks = _stacks(ranges, fwd_queries)
    starts, ends = _merged(backward_open)

    def label(linked: int, corr: int) -> str:
        if linked in launchers:
            key, t = ("launch", linked), launchers[linked][1]
        elif corr in runtime:
            key, t = ("runtime", corr), runtime[corr][1]
        else:
            return "none"
        top = _innermost(launch_stacks[key])
        if top is None:
            return "none"
        if top[0] == "backward":
            stack = forward_stacks.get(("forward", top[2], top[1]))
            fwd = _innermost(stack, program_only=True) if stack is not None else None
            return GRADIENT + (fwd[1] if fwd is not None else "none")
        name = top[1]
        if top[0] == "program" and name.startswith("model.") and _inside(t, starts, ends):
            return RECOMPUTE + name
        return name

    out: Dict[str, float] = {}
    for a, b, linked, corr in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            key = label(linked, corr)
            out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return out


def _merged(spans):
    spans = sorted(spans)
    starts, ends = [], []
    for a, b in spans:
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def _inside(t: int, starts, ends) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < ends[i]


def seconds(spans: Dict[str, float], keys: Iterable[str]) -> Optional[float]:
    """Device seconds of the spans named by ``keys`` (a key ending in "/"
    takes every span under it), or None when none of them is present."""
    hit = [s for name, s in spans.items() if any(name == k or (k.endswith("/") and name.startswith(k)) for k in keys)]
    return sum(hit) if hit else None


def reading(name: str, spans: Optional[Dict[str, float]], units: int) -> Optional[float]:
    """Metric ``name`` of ``METRICS``: device milliseconds per finished unit,
    or None when its spans are absent (a program without them)."""
    s = seconds(spans or {}, METRICS[name])
    if s is None or units <= 0:
        return None
    return 1e3 * s / units


def coverage(spans: Dict[str, float]) -> Dict[str, float]:
    """Shares of the charged device time: to ``model.*`` spans (forward,
    recompute and backward), to ``model.*`` or ``train.*`` spans, and of the
    backward pass's own work (``backward/*`` and ``train.backward``, the
    recompute left out) to ``backward/model.*``."""
    total = sum(spans.values())
    model = sum(s for k, s in spans.items() if k.split("/")[-1].startswith("model."))
    program = sum(s for k, s in spans.items() if k.split("/")[-1].startswith(("model.", "train.")))
    grad = sum(s for k, s in spans.items() if k.startswith(GRADIENT) or k == "train.backward")
    grad_model = sum(s for k, s in spans.items() if k.startswith(GRADIENT + "model."))
    return {"model": model / total if total else 0.0, "program": program / total if total else 0.0,
            "backward_model": grad_model / grad if grad else 0.0}
