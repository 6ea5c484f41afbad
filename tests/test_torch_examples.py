"""The port's examples (``repro_torch.examples``) held to the JAX package's
examples (``examples/*.py``) on the CPU at small sizes.

* Every example is a ``main(argv)`` that runs on the card by default and
  raises without one (no CPU fallback).
* The three launcher examples train or serve reduced granite through the
  port's launchers at a few steps, their asserts holding.
* The NumPy walk-throughs take the same inputs through the JAX engines and
  the port's CPU path: the streaming scheduler's log and HyperX's values
  (goldens, replay, attribution, plan rows) exactly; the telemetry
  dashboard, the fleet planner and the partition analysis exactly where
  the values are integers or event logs, and within 1e-9 elsewhere (the
  simulators' makespans, ROADMAP's deliberate differences).  Plan rows are
  compared with the JAX planner's constants handed to the port's H100
  profile, as ``tests/test_torch_planner.py`` does.
"""

import dataclasses
import importlib
import json
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.planner as jp  # noqa: E402
import repro.network as rn  # noqa: E402
from repro.analysis import roofline  # noqa: E402
from repro.core.bgq import MIDPLANE_DIMS as JAX_MIDPLANE  # noqa: E402
from repro.core.bgq import MIRA as JAX_MIRA  # noqa: E402
from repro.network.scheduler import generate_scenario, run_scenario  # noqa: E402
from repro.obs.contention import attribute_contention  # noqa: E402
from repro.obs.metrics import scheduler_metrics  # noqa: E402
from test_torch_scheduler import as_tuple  # noqa: E402

from repro_torch.analysis import h100  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]
NAMES = ["quickstart", "serve_batched", "fault_tolerant_training", "streaming_scheduler",
         "telemetry_dashboard", "hyperx_analysis", "fleet_planner", "partition_analysis"]
SCENARIO = dict(seed=11, burst_gap=30.0, mean_duration=80.0, failure_rate=0.002, repair_delay=150.0)


def _port(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _jax_example(name, monkeypatch, **env):
    """The JAX example's module-level namespace (its ``__main__`` block
    not run)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name=f"jax_{name}")


@pytest.fixture
def jax_profile(monkeypatch):
    """The port's pricing profile set to the JAX planner's constants."""
    monkeypatch.setattr(h100, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(h100, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(h100, "HBM_BYTES", jp.HBM_BYTES)


def _close(got, want):
    """Equal, floats within 1e-9, through dicts, lists and tuples."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    else:
        assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_every_example_runs_on_the_card_and_raises_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _port(name).main([])


@pytest.mark.parametrize("name, argv", [("quickstart", ["--steps", "10"]),
                                        ("fault_tolerant_training", ["--steps", "12"]),
                                        ("serve_batched", [])])
def test_launcher_examples_on_the_cpu(name, argv):
    out = _port(name).main(argv + CPU)
    if name == "serve_batched":
        assert out["tokens"].shape == (8, 24) and out["tokens_per_s"] > 0
    else:
        assert out[1] < out[0] and all(np.isfinite(out))


def test_streaming_scheduler_log_equals_jax():
    service = _port("streaming_scheduler").main(CPU)  # the JAX example's 150 jobs
    want = run_scenario(generate_scenario((16, 16, 16), 150, **SCENARIO), rn.IsoperimetricPolicy(),
                        backfill=True)
    assert {"fail", "reclaim"} <= {e.kind for e in service.log}
    assert [as_tuple(e) for e in service.log] == [as_tuple(e) for e in want.log]


def test_telemetry_dashboard_matches_jax(tmp_path):
    report = _port("telemetry_dashboard").main(["--jobs", "30", "--out-dir", str(tmp_path)] + CPU)
    service = run_scenario(generate_scenario((16, 16, 16), 30, **SCENARIO), rn.ContentionScoredPolicy(),
                           backfill=True)
    assert json.loads((tmp_path / "metrics.json").read_text()) == scheduler_metrics(service).snapshot()
    names = {e["name"] for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"scheduler.step", "scheduler.place"} <= names
    machine = rn.MachineState((16, 16, 16))
    machine.allocate(0, (8, 8, 8))
    machine.allocate(1, (16, 16, 2))
    want = attribute_contention(machine)
    assert [dataclasses.astuple(j) for j in report.jobs] == [dataclasses.astuple(j) for j in want.jobs]
    assert (report.total_load, report.max_link_load, report.cross_load) == \
        (want.total_load, want.max_link_load, want.cross_load)


def test_hyperx_analysis_values_equal_jax(monkeypatch, jax_profile):
    want = _jax_example("hyperx_analysis", monkeypatch, REPLAY_JOBS="40")
    got = _port("hyperx_analysis").main(["--jobs", "40"] + CPU)
    assert got["ranked"] == want["ranked"]
    assert dataclasses.astuple(got["advice"]) == dataclasses.astuple(want["adv"])
    assert got["makespans"] == want["makespans"]
    for key, cmp in (("pairing", "pairing_cmp"), ("hotspot", "hotspot_cmp")):
        assert (got[key].dor_makespan, got[key].adaptive_makespan, got[key].recovered_fraction) == \
            (want[cmp].dor_makespan, want[cmp].adaptive_makespan, want[cmp].recovered_fraction)
    assert got["replay"] == want["rows"]
    assert [dataclasses.astuple(j) for j in got["report"].jobs] == \
        [dataclasses.astuple(j) for j in want["report"].jobs]
    assert [c.row() for c in got["plan"].table] == [c.row() for c in want["plan"].table]


def test_fleet_planner_plans_equal_jax(jax_profile):
    archs = ["granite-3-8b", "mixtral-8x7b"]
    got = _port("fleet_planner").main(["--archs", ",".join(archs), "--pod", "mira"] + CPU)
    want = jp.plan_fleet(archs, pod=rn.TorusFabric.bgq(JAX_MIRA.midplane_dims, link_bw=2e9),
                         wrap_mode="torus", unit_node_dims=JAX_MIDPLANE, simulate_top_k=1)
    for a, b in zip(got, want, strict=True):
        assert [c.row() for c in a.table] == [c.row() for c in b.table]
        assert a.simulated_slowdown == pytest.approx(b.simulated_slowdown, rel=1e-9)
        assert jp.format_table(b, top=4) == _port("fleet_planner").format_table(a, top=4)


def test_fleet_planner_on_juqueen_with_the_h100_profile():
    plans = _port("fleet_planner").main(["--pod", "juqueen"] + CPU)
    assert len(plans) == 11 and all(p.simulated_slowdown >= 1.0 for p in plans)


def _advice(a):
    return (a.units, a.current_geometry, a.optimal_geometry, a.current_bisection, a.optimal_bisection,
            a.predicted_speedup, a.simulated_speedup, a.certified)


def test_partition_analysis_sections_equal_jax(monkeypatch):
    n = 24
    jx = _jax_example("partition_analysis", monkeypatch)
    got = _port("partition_analysis").main(["--jobs", str(n)] + CPU)

    for plan, chips in zip(got["slice_plans"], (16, 32, 64), strict=True):
        want = jx["plan_slice"](chips)
        assert (plan.slice_geometry, plan.slice_bisection_links, plan.worst_geometry,
                plan.worst_bisection_links, plan.avoidable_contention) == \
            (want.slice_geometry, want.slice_bisection_links, want.worst_geometry,
             want.worst_bisection_links, want.avoidable_contention)
    mira = jx["MIRA"]
    advice = []
    for a in rn.advise_policy_table(mira.midplane_dims, jx["MIRA_SCHEDULER_PARTITIONS"],
                                    unit_node_dims=JAX_MIDPLANE):
        if not a.is_current_optimal and a.units in jx["SIMULATED_ADVISOR_SIZES"]:
            a = rn.advise_partition(mira.midplane_dims, a.units, jx["MIRA_SCHEDULER_PARTITIONS"][a.units],
                                    unit_node_dims=JAX_MIDPLANE, simulate=True)
        advice.append(a)
    advice.append(rn.advise_partition(jx["JUQUEEN"].midplane_dims, 8, unit_node_dims=JAX_MIDPLANE,
                                      simulate=True))
    assert [_advice(a) for a in got["advice"]] == [_advice(a) for a in advice]

    drop_wall = lambda rows: [{k: v for k, v in r.items() if k != "replay_s"} for r in rows]
    _close(drop_wall(got["replay"]), drop_wall(jx["replay_policies"](n)))
    _close(got["juqueen"], jx["juqueen_shared_fabric_replay"](n // 3))
    assert got["mapping"] == jx["mapping_recovery_study"]()
    _close(got["replay_mapping"], jx["replay_mapping_study"](n // 4))
    _close(list(got["netsim"]), list(jx["netsim_validation_table"]()))
    for a, b in zip(got["routing"], jx["routing_recovery_study"](), strict=True):
        assert (a.dor_makespan, a.adaptive_makespan, a.recovered_fraction) == \
            (b.dor_makespan, b.adaptive_makespan, b.recovered_fraction)
    _close(list(got["simulated"]), list(jx["simulated_contention_replay"](n // 2)))
    assert got["scoring"]["batch"] == 512 and got["scoring"]["device"] == "cpu"
