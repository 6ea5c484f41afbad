"""Parity of the port's metrics registry and ``scheduler_metrics``
(``repro_torch.obs.metrics``) with ``repro.obs.metrics``, on the CPU.

The same instruments give the same snapshot; the same seeded scenarios
through both schedulers give snapshots equal key for key and value for
value, and a replayed log (``replay_events``) gives the original's
snapshot exactly, as ``tests/test_obs.py`` pins for the JAX package.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.obs import metrics as jax_metrics  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import metrics as port_metrics  # noqa: E402

CPU = "cpu"
SCENARIOS = [
    ((8, 8, 8), 40, dict(seed=9, failure_rate=0.003), True),
    ((4, 4, 4), 36, dict(seed=0, max_fraction=0.5, mean_duration=80.0, failure_rate=0.01, repair_delay=60.0), False),
    ((6, 4, 2), 30, dict(seed=1, max_fraction=0.5, mean_duration=90.0, failure_rate=0.02, repair_delay=40.0), True),
]


def _drive(reg):
    reg.counter("hits", route="a").incr()
    reg.counter("hits", route="a").incr(2)
    reg.counter("hits", route="b").incr()
    reg.gauge("temp").set(3.5)
    reg.gauge("temp", zone=2).set(-1.25)
    h = reg.histogram("lat")
    for v in (0.002, 0.02, 5.0, 1e6, 0.0, -3.0):
        h.observe(v)
    reg.histogram("custom", buckets=(1.0, 2.0)).observe(1.5)
    return reg


def test_registry_snapshot_equals_jax():
    got = _drive(port_metrics.MetricsRegistry()).snapshot()
    want = _drive(jax_metrics.MetricsRegistry()).snapshot()
    assert got == want
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert port_metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS
    with pytest.raises(ValueError, match="counters only increase"):
        port_metrics.MetricsRegistry().counter("c").incr(-1)
    empty = port_metrics.Histogram().to_dict()
    assert empty == jax_metrics.Histogram().to_dict()


def test_registry_export_and_facade(tmp_path):
    reg = _drive(port_metrics.MetricsRegistry())
    path = tmp_path / "m.json"
    assert reg.export(str(path)) == json.loads(path.read_text())
    reg.clear()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


@pytest.mark.parametrize("dims, n, kw, backfill", SCENARIOS, ids=["8x8x8", "4x4x4", "6x4x2"])
def test_scheduler_metrics_equal_jax_and_survive_replay(dims, n, kw, backfill):
    want_s = rn.generate_scenario(dims, n, **kw)
    got_s = tn.generate_scenario(dims, n, **kw)
    want = rn.run_scenario(want_s, rn.IsoperimetricPolicy(), backfill=backfill)
    got = tn.run_scenario(got_s, tn.IsoperimetricPolicy(), backfill=backfill, device=CPU)
    snap = obs.scheduler_metrics(got).snapshot()
    assert snap == jax_obs.scheduler_metrics(want).snapshot()
    replayed = tn.replay_events(dims, tn.IsoperimetricPolicy(), got.log, backfill=backfill, device=CPU)
    assert obs.scheduler_metrics(replayed).snapshot() == snap
    events = sum(v for k, v in snap["counters"].items() if k.startswith("scheduler.events{"))
    assert events == len(got.log)
    last = {job.placement.job_id: job for job in got.result().jobs}
    for job_id, job in last.items():
        assert snap["gauges"][f"scheduler.job.bisection_efficiency{{job={job_id}}}"] == job.bisection_efficiency
    assert 0.0 < snap["gauges"]["scheduler.utilization"] <= 1.0


def test_scheduler_metrics_with_preemption_and_backpressure_equal_jax():
    def stream(pkg):
        rng = np.random.default_rng(4)
        return [pkg.JobRequest(i, int(rng.choice([4, 8, 16, 32])), duration=float(rng.uniform(2, 9)),
                               arrival=float(i) * 0.7) for i in range(24)]

    services = []
    for pkg, kw in ((rn, {}), (tn, {"device": CPU})):
        svc = pkg.SchedulerService((4, 4, 4), pkg.IsoperimetricPolicy(), backfill=True, max_waiting=5,
                                   preempt_priority=True, **kw)
        for i, req in enumerate(stream(pkg)):
            svc.submit(req, priority=i % 3)
        svc.inject_preempt(6.0, 1)
        services.append(svc.run())
    reg = port_metrics.MetricsRegistry()
    assert obs.scheduler_metrics(services[1], reg) is reg
    assert reg.snapshot() == jax_obs.scheduler_metrics(services[0]).snapshot()
    kinds = {e.kind for e in services[1].log}
    assert "preempt" in kinds and "reject" in kinds


def test_scheduler_metrics_of_an_empty_log():
    svc = tn.SchedulerService((2, 2), tn.IsoperimetricPolicy(), device=CPU)
    snap = obs.scheduler_metrics(svc).snapshot()
    want = jax_obs.scheduler_metrics(rn.SchedulerService((2, 2), rn.IsoperimetricPolicy())).snapshot()
    assert snap == want and snap["gauges"]["scheduler.utilization"] == 0.0
