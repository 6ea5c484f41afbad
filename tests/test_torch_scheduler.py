"""Parity of the port's event-sourced scheduler (``repro_torch.network.
scheduler``) with the JAX package's, on the CPU.

The same seeded scenarios go through both services; the event logs are
compared record for record through :func:`as_tuple` (every field, the
predicted contention rounded to 9 decimals), across the five policies,
with backfill on and off, failures and repairs, preemption and reclaim,
priority preemption and backpressure.  A JAX log also replays through
``repro_torch.interop.events_from_numpy``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.core import bgq  # noqa: E402
from repro.runtime.fault_tolerance import HeartbeatMonitor as JaxMonitor  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.interop import events_from_numpy  # noqa: E402
from repro_torch.network import scheduler as port_scheduler  # noqa: E402
from repro_torch.runtime import HeartbeatMonitor as PortMonitor  # noqa: E402

CPU = "cpu"
LIST_TABLE = {1: (1, 1, 1), 2: (2, 1, 1), 4: (2, 2, 1), 8: (2, 2, 2), 16: (4, 2, 2), 32: (4, 4, 2)}


def as_tuple(event):
    """Every field of a scheduler record, from either package."""
    request = None if event.request is None else dataclasses.astuple(event.request)
    placement = None
    if event.placement is not None:
        p = event.placement
        placement = (p.job_id, p.geometry, p.oriented, p.offset, p.bisection_links,
                     round(p.predicted_contention, 9))
    return (event.time, event.kind, event.seq, event.job_id, event.cells, request, placement,
            event.priority, event.reason, event.source)


def policy(package, name):
    return {
        "elongated": package.ElongatedPolicy,
        "isoperimetric": package.IsoperimetricPolicy,
        "list": lambda: package.ListPolicy(LIST_TABLE),
        "hinted": package.HintedPolicy,
        "contention-scored": package.ContentionScoredPolicy,
    }[name]()


POLICIES = ["elongated", "isoperimetric", "list", "hinted", "contention-scored"]
SCENARIOS = [  # (machine, jobs, generate_scenario options)
    ((4, 4, 4), 36, dict(seed=0, max_fraction=0.5, mean_duration=80.0, failure_rate=0.01, repair_delay=60.0)),
    ((6, 4, 2), 30, dict(seed=1, max_fraction=0.5, mean_duration=90.0, failure_rate=0.02, repair_delay=40.0)),
]


def _scenarios(dims, n, kw):
    return rn.generate_scenario(dims, n, **kw), tn.generate_scenario(dims, n, **kw)


@pytest.mark.parametrize("dims, n, kw", SCENARIOS, ids=["4x4x4", "6x4x2"])
def test_generate_scenario_matches_jax(dims, n, kw):
    want, got = _scenarios(dims, n, kw)
    assert [dataclasses.astuple(j) for j in got.jobs] == [dataclasses.astuple(j) for j in want.jobs]
    assert got.failures == want.failures and got.repairs == want.repairs
    assert got.machine_dims == want.machine_dims
    assert want.failures  # the scenarios do inject failures


@pytest.mark.parametrize("dims, n, kw", SCENARIOS, ids=["4x4x4", "6x4x2"])
@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("backfill", [False, True])
def test_run_scenario_logs_match_jax(dims, n, kw, name, backfill):
    want_s, got_s = _scenarios(dims, n, kw)
    want = rn.run_scenario(want_s, policy(rn, name), backfill=backfill, max_waiting=24)
    got = tn.run_scenario(got_s, policy(tn, name), backfill=backfill, max_waiting=24, device=CPU)
    assert [as_tuple(e) for e in got.log] == [as_tuple(e) for e in want.log]
    assert got.rejected == want.rejected and got.shed == want.shed
    assert got.failed_cells == want.failed_cells and got.now == want.now
    kinds = {e.kind for e in want.log}
    assert {"fail", "reclaim", "start", "complete"} <= kinds


def _busy_stream(package, seed=3, n=40):
    """Large jobs arriving faster than they finish: the head blocks."""
    rng = np.random.default_rng(seed)
    t = 0.0
    jobs = []
    for i in range(n):
        t += float(rng.exponential(1.0))
        jobs.append(package.JobRequest(i, int(rng.choice([4, 8, 16, 32, 64])),
                                       duration=float(rng.uniform(2.0, 12.0)), arrival=t))
    return jobs


@pytest.mark.parametrize("name", POLICIES)
def test_blocking_backfill_backpressure_and_failures_match_jax(name):
    logs = []
    for package, kw in ((rn, {}), (tn, {"device": CPU})):
        svc = package.SchedulerService((4, 4, 4), policy(package, name), backfill=True, max_waiting=6, **kw)
        for job in _busy_stream(package):
            svc.submit(job)
        svc.inject_failure(9.0, [(1, 1, 1), (2, 3, 0)])
        svc.inject_reclaim(20.0, cells=[(1, 1, 1), (2, 3, 0)])
        logs.append(svc.run())
    want, got = logs
    assert [as_tuple(e) for e in got.log] == [as_tuple(e) for e in want.log]
    assert got.shed == want.shed and want.shed  # backpressure shed some arrivals
    starts = [e.job_id for e in want.log if e.kind == "start"]
    assert starts != sorted(starts)  # backfill started a job ahead of an earlier one


def _drive(package, dims, name, **service):
    svc = package.SchedulerService(dims, policy(package, name), **service)
    for i, (units, prio, arrival, duration) in enumerate(
        [(8, 0, 0.0, 5.0), (16, 0, 0.5, 4.0), (8, 1, 1.0, 2.0), (32, 2, 1.5, 1.0),
         (4, 0, 2.0, 3.0), (2, 1, 2.0, 6.0), (16, 0, 3.0, 2.0), (64, 0, 3.5, 1.0)]
    ):
        svc.submit(package.JobRequest(i, units, duration=duration, arrival=arrival,
                                      contention_bound=bool(i % 2)), priority=prio)
    svc.inject_preempt(2.5, 0)
    svc.inject_reclaim(6.0, job_id=0)
    svc.inject_failure(3.2, [(0, 0, 0), (3, 3, 1)])
    svc.inject_reclaim(9.0, cells=[(0, 0, 0)])
    svc.inject_preempt(7.0, 99)  # not running: logged as input
    return svc.run()


@pytest.mark.parametrize("name", POLICIES)
def test_preemption_reclaim_and_failures_match_jax(name):
    for service in (dict(preempt_priority=True), dict(backfill=True, max_waiting=3)):
        want = _drive(rn, (4, 4, 4), name, **service)
        got = _drive(tn, (4, 4, 4), name, device=CPU, **service)
        assert [as_tuple(e) for e in got.log] == [as_tuple(e) for e in want.log]
        assert {e.reason for e in want.log} >= {"external", "failure", "not-running"}
    assert any(e.reason == "priority" for e in _drive(rn, (4, 4, 4), name, preempt_priority=True).log)


@pytest.mark.parametrize("name", ["isoperimetric", "contention-scored"])
def test_events_from_numpy_replays_a_jax_log(name):
    want_s, _ = _scenarios(*SCENARIOS[1])
    want = rn.run_scenario(want_s, policy(rn, name), backfill=True)
    records = events_from_numpy(want.log)
    assert all(isinstance(e, port_scheduler.Event) for e in records)
    assert [as_tuple(e) for e in records] == [as_tuple(e) for e in want.log]
    again = tn.replay_events(want_s.machine_dims, policy(tn, name), records, backfill=True, device=CPU)
    assert [as_tuple(e) for e in again.log] == [as_tuple(e) for e in want.log]


def test_replay_of_the_ports_own_log_and_the_mira_list_policy():
    jobs = [(1, 0.0), (4, 0.0), (8, 1.0), (16, 1.5), (24, 2.0), (2, 2.0), (48, 2.5), (4, 3.0)]
    logs = []
    for package, kw in ((rn, {}), (tn, {"device": CPU})):
        svc = package.SchedulerService((4, 4, 3, 2), package.ListPolicy(bgq.MIRA_SCHEDULER_PARTITIONS),
                                       unit_node_dims=(4, 4, 4, 4, 2), backfill=True, **kw)
        for i, (units, t) in enumerate(jobs):
            svc.submit(package.JobRequest(i, units, duration=2.0 + i, arrival=t))
        logs.append(svc.run())
    want, got = logs
    assert [as_tuple(e) for e in got.log] == [as_tuple(e) for e in want.log]
    want_jobs = [(j.request.job_id, j.start, j.end, j.predicted_comm_time, j.bisection_efficiency)
                 for j in want.result().jobs]
    assert [(j.request.job_id, j.start, j.end, j.predicted_comm_time, j.bisection_efficiency)
            for j in got.result().jobs] == want_jobs
    again = tn.replay_events((4, 4, 3, 2), tn.ListPolicy(bgq.MIRA_SCHEDULER_PARTITIONS), got.log,
                             unit_node_dims=(4, 4, 4, 4, 2), backfill=True, device=CPU)
    assert [as_tuple(e) for e in again.log] == [as_tuple(e) for e in got.log]


def test_monitor_failures_reach_the_service():
    logs = []
    for package, monitor_cls, kw in ((rn, JaxMonitor, {}), (tn, PortMonitor, {"device": CPU})):
        clock = [0.0]
        monitor = monitor_cls(["w0", "w1", "w2"], timeout=1.0, clock=lambda: clock[0])
        svc = package.SchedulerService((4, 4, 4), package.IsoperimetricPolicy(), **kw)
        svc.submit(package.JobRequest(0, 64, duration=10.0))
        svc.run(until=1.0)
        clock[0] = 2.0
        monitor.beat("w1")
        cells = package.apply_monitor_failures(svc, monitor, {"w0": (0, 0, 0), "w1": (1, 1, 1)}, time=2.0)
        assert cells == [(0, 0, 0)]
        svc.run()
        logs.append(svc.log)
    assert [as_tuple(e) for e in logs[1]] == [as_tuple(e) for e in logs[0]]


def test_event_clock_helpers_match_jax():
    for t in (0.0, 1.0, 3e4, 1e5, -7.5e7):
        assert port_scheduler.time_eps(t, 2 * t) == rn.time_eps(t, 2 * t)
        for b in (t, t + 1e-13, t + port_scheduler.time_eps(t) * 3):
            assert port_scheduler.time_close(t, b) == rn.time_close(t, b)
            assert port_scheduler.time_le(t, b) == rn.scheduler.time_le(t, b)
            assert port_scheduler.time_lt(t, b) == rn.scheduler.time_lt(t, b)


def test_scheduler_throughput_and_spans():
    _, scenario = _scenarios(*SCENARIOS[0])
    obs.enable_tracing(clear=True)
    try:
        svc, events_per_s = tn.scheduler_throughput(scenario, tn.ContentionScoredPolicy(), backfill=True, device=CPU)
    finally:
        obs.disable_tracing()
    names = {e["name"] for e in obs.export_chrome_trace()["traceEvents"]}
    assert {"scheduler.scenario", "scheduler.step", "scheduler.place", "placement.search"} <= names
    assert events_per_s > 0 and svc.events_processed == len(svc.log)
    quiet = tn.run_scenario(scenario, tn.ContentionScoredPolicy(), backfill=True, device=CPU)
    assert [as_tuple(e) for e in quiet.log] == [as_tuple(e) for e in svc.log]  # spans only measure


SERVICE_ENTRY_POINTS = {
    "SchedulerService": lambda: tn.SchedulerService((4, 4), tn.IsoperimetricPolicy()),
    "run_scenario": lambda: tn.run_scenario(tn.generate_scenario((4, 4), 2), tn.IsoperimetricPolicy()),
    "scheduler_throughput": lambda: tn.scheduler_throughput(tn.generate_scenario((4, 4), 2), tn.IsoperimetricPolicy()),
    "replay_events": lambda: tn.replay_events((4, 4), tn.IsoperimetricPolicy(), []),
    "advise_policy_table": lambda: tn.advise_policy_table((4, 4, 3, 2), {4: (4, 1, 1, 1)}),
}


@pytest.mark.parametrize("name", sorted(SERVICE_ENTRY_POINTS))
def test_default_device_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SERVICE_ENTRY_POINTS[name]()
