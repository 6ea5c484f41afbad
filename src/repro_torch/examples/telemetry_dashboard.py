"""Telemetry walk-through: trace a scheduler replay, derive metrics from its
event log, and attribute per-link contention on the live machine (the port
of ``examples/telemetry_dashboard.py``).

1. tracing is enabled (it is off by default) and a seeded bursty scenario
   on a 16^3 torus runs through the event-sourced service on ``--device``:
   every ``scheduler.step`` / ``scheduler.place`` / ``placement.search``
   boundary becomes a span, exported as a Chrome trace-event JSON (load it
   at ``chrome://tracing`` or https://ui.perfetto.dev);
2. ``scheduler_metrics`` derives counters, gauges and latency histograms
   purely from the event log, so a replayed service would reproduce the
   snapshot exactly;
3. ``attribute_contention`` decomposes the machine's all-to-all link field
   by owning job on the machine's device and prices each placement
   against the isoperimetry engine's certified optimum: the paper's
   avoidable-contention gauge.  A deliberately bad (16, 16, 2) slab next
   to the optimal (8, 8, 8) cube shows the 2x avoidable pairing load of
   Theorem 3.1 in the dashboard.

    PYTHONPATH=src python -m repro_torch.examples.telemetry_dashboard               # on the card
    PYTHONPATH=src python -m repro_torch.examples.telemetry_dashboard --device cpu --jobs 30

``--jobs`` scales the workload (80); trace.json, metrics.json and
contention.json go to ``--out-dir`` (the working directory).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import repro_torch.obs as obs
from repro_torch.device import resolve_device
from repro_torch.network import MachineState
from repro_torch.network.allocation import ContentionScoredPolicy
from repro_torch.network.scheduler import generate_scenario, run_scenario
from repro_torch.obs.contention import ContentionReport, attribute_contention, render_dashboard
from repro_torch.obs.metrics import scheduler_metrics

DIMS = (16, 16, 16)


def main(argv: Optional[List[str]] = None) -> ContentionReport:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=80)
    ap.add_argument("--out-dir", type=Path, default=Path("."))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scenario = generate_scenario(
        DIMS,
        args.jobs,
        seed=11,
        burst_gap=30.0,
        mean_duration=80.0,
        failure_rate=0.002,
        repair_delay=150.0,
    )
    args.out_dir.mkdir(parents=True, exist_ok=True)

    # 1. traced run -> Chrome trace
    obs.enable_tracing(clear=True)
    service = run_scenario(scenario, ContentionScoredPolicy(), backfill=True, device=dev)
    obs.disable_tracing()
    trace_path = args.out_dir / "trace.json"
    obs.export_chrome_trace(trace_path)
    events = obs.TRACER.events()
    names = sorted({e["name"] for e in events})
    print(f"machine {DIMS}, {args.jobs} jobs -> {len(events)} spans ({', '.join(names)})")
    print(f"chrome trace: {trace_path} (open in chrome://tracing)")

    # 2. metrics derived from the event log
    registry = scheduler_metrics(service)
    snap = registry.snapshot()
    metrics_path = args.out_dir / "metrics.json"
    registry.export(metrics_path)
    waits = snap["histograms"]["scheduler.wait_time"]
    print(f"metrics: {len(snap['counters'])} counters, "
          f"{len(snap['gauges'])} gauges, {len(snap['histograms'])} histograms -> {metrics_path}")
    print(f"  utilization {snap['gauges']['scheduler.utilization']:.3f}, "
          f"waits n={waits['count']} mean={waits['sum'] / max(waits['count'], 1):.1f}")

    # 3. avoidable-contention attribution on a live machine: the paper's
    #    (8,8,8)-vs-(16,16,2) pair, the same 512 units, 2x the pairing load
    machine = MachineState(DIMS, device=dev)
    machine.allocate(0, (8, 8, 8))
    machine.allocate(1, (16, 16, 2))
    report = attribute_contention(machine)
    print()
    print(render_dashboard(report))
    contention_path = args.out_dir / "contention.json"
    contention_path.write_text(report.to_json())
    print(f"contention report: {contention_path}")

    by_id = {j.job_id: j for j in report.jobs}
    assert abs(by_id[0].avoidable_excess) < 1e-9
    assert abs(by_id[1].avoidable_ratio - 2.0) < 1e-9
    doc = json.loads(trace_path.read_text())
    assert doc["traceEvents"], "trace export is empty"
    return report


if __name__ == "__main__":
    main()
