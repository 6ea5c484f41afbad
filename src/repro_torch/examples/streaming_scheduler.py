"""Streaming-scheduler walk-through: a seeded bursty scenario with node
failures driven through the event-sourced service, then replayed (the port
of ``examples/streaming_scheduler.py``).

1. ``generate_scenario`` draws a bursty, heavy-tailed workload for a 16^3
   torus (Pareto job sizes snapped to axis-divisor cuboid volumes,
   log-normal durations) plus Poisson cell failures with delayed repairs.
2. ``SchedulerService`` schedules it online under the isoperimetric policy
   with backfill, logging every event, its machine state and placement
   search on ``--device``; failures evacuate and requeue their victims,
   repairs return cells to the pool.
3. ``replay_events`` re-drives a fresh service from the log's *input*
   records and must reproduce the run record for record.

    PYTHONPATH=src python -m repro_torch.examples.streaming_scheduler               # on the card
    PYTHONPATH=src python -m repro_torch.examples.streaming_scheduler --device cpu --jobs 40
"""

from __future__ import annotations

import argparse
import time
from collections import Counter
from typing import List, Optional

from repro_torch.device import resolve_device
from repro_torch.network import IsoperimetricPolicy, replay_events
from repro_torch.network.scheduler import SchedulerService, generate_scenario, run_scenario

DIMS = (16, 16, 16)


def main(argv: Optional[List[str]] = None) -> SchedulerService:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=150)
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
    policy = IsoperimetricPolicy()

    t0 = time.perf_counter()
    service = run_scenario(scenario, policy, backfill=True, device=dev)
    elapsed = time.perf_counter() - t0

    kinds = Counter(e.kind for e in service.log)
    print(f"machine {DIMS}, {args.jobs} jobs, {len(scenario.failures)} failure events, device {dev}")
    print(f"processed {service.events_processed} events in {elapsed:.2f}s "
          f"({service.events_processed / elapsed:.0f} events/s)")
    print("log breakdown:", dict(sorted(kinds.items())))
    print(f"scheduled segments: {len(service.scheduled)}, "
          f"rejected: {len(service.rejected)}, shed: {len(service.shed)}")

    makespan = max((j.end for j in service.scheduled), default=0.0)
    print(f"makespan: {makespan:.1f}")

    replayed = replay_events(DIMS, policy, service.log, backfill=True, device=dev)
    assert replayed.log == service.log, "replay diverged from the original run"
    print(f"replay: {len(replayed.log)} records reproduced record-for-record")
    return service


if __name__ == "__main__":
    main()
