"""Parity of the port's fleet planner (``repro_torch.launch.planner`` and
``launch.mesh``) with the JAX package's, on the CPU.

The JAX planner prices with its own hardware constants; the port reads the
H100 profile (``repro_torch.analysis.h100``).  The parity tests hand the
port the JAX constants through the ``jax_profile`` fixture, and then every
ranked row is bit-equal to the JAX planner's (``row()`` compared with
``==``), as ``tests/test_planner.py`` holds the JAX planner to its oracle.
The last tests pin what the H100 profile itself gives on Mira.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.mesh as jax_mesh  # noqa: E402
import repro.launch.planner as jp  # noqa: E402
import repro.network as rn  # noqa: E402
from repro.analysis import roofline  # noqa: E402
from repro.configs import ArchConfig as JaxArch  # noqa: E402
from repro.configs import MoEConfig as JaxMoE  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.bgq import MIDPLANE_DIMS as JAX_MIDPLANE  # noqa: E402
from repro.core.bgq import MIRA as JAX_MIRA  # noqa: E402
from repro.network.fabric import DEFAULT_LINK_BW, POD_DCI_BW  # noqa: E402

import repro_torch.launch.mesh as tm  # noqa: E402
import repro_torch.launch.planner as tp  # noqa: E402
import repro_torch.network as tn  # noqa: E402
from repro_torch.analysis import h100  # noqa: E402
from repro_torch.configs import ArchConfig as PortArch  # noqa: E402
from repro_torch.configs import MoEConfig as PortMoE  # noqa: E402
from repro_torch.configs import get_arch as port_get_arch  # noqa: E402
from repro_torch.core import bgq  # noqa: E402
from repro_torch.obs import TRACER  # noqa: E402

CPU = "cpu"
ARCHS = ["granite-3-8b", "llama3-70b", "qwen1.5-110b", "nemotron-4-340b", "command-r-35b",
         "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "internvl2-1b", "musicgen-large",
         "rwkv6-3b", "zamba2-2.7b"]
_TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
TINY = {  # tests/test_planner.py's TINY_DENSE and TINY_MOE, from both packages
    "tiny-dense": (JaxArch(name="tiny-dense", family="dense", **_TINY),
                   PortArch(name="tiny-dense", family="dense", **_TINY)),
    "tiny-moe": (JaxArch(name="tiny-moe", family="moe", moe=JaxMoE(num_experts=4, top_k=2), **_TINY),
                 PortArch(name="tiny-moe", family="moe", moe=PortMoE(num_experts=4, top_k=2), **_TINY)),
}
# subsets of tests/test_planner.py's SLICE_CASES and TORUS_CASES
SLICE_CASES = [((4, 2), 8), ((4, 4), 8), ((2, 2, 2), 4), ((4, 2, 2), 8), ((6, 2), 4), ((2, 2, 2, 2), 8)]
TORUS_CASES = [((2, 2, 2), 4), ((4, 2, 2), 8), ((4, 4, 2), 8), ((2, 2, 2, 2), 4)]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k"]
# tests/test_golden_tables.py::GOLDEN_FLEET_PLANS: arch -> (best (d,f,t,e),
# best mapping, step s, comm s, worst/best step ratio, table rows)
GOLDEN_FLEET_PLANS = {
    "mixtral-8x7b": ((1, 16, 1, 1), "gray-snake", 65.76192673719228, 65.67542784, 68.97977716257631, 52),
    "qwen1.5-110b": ((1, 16, 1, 1), "gray-snake", 156.98542122669093, 156.38593536000002, 24.626936833096032, 13),
    "nemotron-4-340b": ((16, 1, 1, 1), "gray-snake", 322.1977022487287, 320.374259712, 32.39810184542654, 36),
}


def _set_jax_profile(mp):
    mp.setattr(h100, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    mp.setattr(h100, "HBM_BW", roofline.HBM_BW)
    mp.setattr(h100, "HBM_BYTES", jp.HBM_BYTES)


@pytest.fixture
def jax_profile(monkeypatch):
    """The port's pricing profile set to the JAX planner's constants."""
    _set_jax_profile(monkeypatch)


def _pods(dims, mode):
    if mode == "slice":
        return rn.TorusFabric.tpu(dims), tn.TorusFabric.tpu(dims, link_bw=DEFAULT_LINK_BW)
    return rn.TorusFabric.bgq(dims, link_bw=2e9), tn.TorusFabric.bgq(dims, link_bw=2e9)


def _rows(plan):
    return [c.row() for c in plan.table]


def _plans(cfg_name, dims, chips, mode, shape, **kw):
    jcfg, pcfg = TINY[cfg_name]
    jpod, ppod = _pods(dims, mode)
    want = jp.plan_model(jcfg, chips, pod=jpod, shape=shape, wrap_mode=mode, **kw)
    got = tp.plan_model(pcfg, chips, pod=ppod, shape=shape, wrap_mode=mode, device=CPU, **kw)
    return got, want


@pytest.mark.parametrize("case", [("slice",) + c for c in SLICE_CASES] + [("torus",) + c for c in TORUS_CASES])
@pytest.mark.parametrize("cfg", sorted(TINY))
def test_plan_model_rows_are_bit_equal_to_jax(jax_profile, case, cfg):
    mode, dims, chips = case
    for shape in SHAPE_NAMES:
        got, want = _plans(cfg, dims, chips, mode, shape)
        assert _rows(got) == _rows(want), (mode, dims, chips, cfg, shape)
        assert [c.sort_key() for c in got.table] == [c.sort_key() for c in want.table]
        assert [(c.bisection_links, c.bisection_efficiency, c.pair_volume_node, c.node_dims, c.traffic)
                for c in got.table] == \
            [(c.bisection_links, c.bisection_efficiency, c.pair_volume_node, c.node_dims, c.traffic)
             for c in want.table]
        assert (got.arch, got.shape, got.chips, got.pod_dims, got.wrap_mode) == \
            (want.arch, want.shape, want.chips, want.pod_dims, want.wrap_mode)


@pytest.fixture(scope="module")
def mira_plans():
    """The golden's three Mira plans at 16 midplanes from both packages,
    the port handed the JAX constants."""
    jpod = rn.TorusFabric.bgq(JAX_MIRA.midplane_dims, link_bw=2e9)
    ppod = tp.bgq_pod("mira")
    plans = {}
    with pytest.MonkeyPatch.context() as mp:
        _set_jax_profile(mp)
        for arch in GOLDEN_FLEET_PLANS:
            want = jp.plan_model(arch, 16, pod=jpod, shape="train_4k", wrap_mode="torus",
                                 unit_node_dims=JAX_MIDPLANE)
            got = tp.plan_model(arch, 16, pod=ppod, shape="train_4k", wrap_mode="torus",
                                unit_node_dims=bgq.MIDPLANE_DIMS, device=CPU)
            plans[arch] = (got, want)
    return plans


@pytest.mark.parametrize("arch", sorted(GOLDEN_FLEET_PLANS))
def test_mira_golden_fleet_plans(mira_plans, arch):
    """The Mira golden of tests/test_golden_tables.py, reproduced by the
    port: the certified (2, 2, 2, 2) cube, advise_partition's optimum, and
    rows bit-equal to the JAX planner's."""
    axes, strategy, step, comm, ratio, n_rows = GOLDEN_FLEET_PLANS[arch]
    got, want = mira_plans[arch]
    assert port_get_arch(arch).param_count() == jax_get_arch(arch).param_count()
    assert _rows(got) == _rows(want)
    best, worst = got.table[0], got.table[-1]
    assert got.geometry == (2, 2, 2, 2)
    assert got.bisection_efficiency == pytest.approx(1.0)
    adv = tn.advise_partition(bgq.MIRA.midplane_dims, 16, got.geometry, unit_node_dims=bgq.MIDPLANE_DIMS,
                              device=CPU)
    assert adv.optimal_geometry == got.geometry and adv.current_bisection == adv.optimal_bisection
    assert best.axis_sizes == axes and best.mapping_strategy == strategy
    assert best.step_time == pytest.approx(step, rel=1e-9)
    assert best.comm_time == pytest.approx(comm, rel=1e-9)
    assert worst.step_time / best.step_time == pytest.approx(ratio, rel=1e-9)
    assert worst.step_time / best.step_time >= 1.3
    assert len(got.table) == n_rows


def _assert_comm_reproduced(cand):
    """A row's comm time rebuilt outside the planner: assign_axes(mapping=)
    + COLLECTIVE_TIME for the rings, the drained pairing for the rest."""
    assignment = tn.assign_axes(cand.fabric, cand.rule.mesh_shape, order_hint=cand.rule.order_hint,
                                mapping=cand.mapping)
    ring = 0.0
    for axis, collective, vol in cand.traffic:
        ring += tn.COLLECTIVE_TIME[collective](vol, assignment.embedding(axis), cand.fabric.link_bw)
    assert ring == cand.ring_time
    if cand.pair_volume_node > 0.0:
        sim = tn.simulate_traffic(cand.node_dims, tn.bisection_pairing(cand.node_dims),
                                  link_bw=cand.fabric.link_bw,
                                  double_link_on_2=cand.fabric.double_link_on_2, device=CPU)
        assert math.isclose(cand.pairing_time, cand.pair_volume_node * sim.makespan, rel_tol=1e-9)
    else:
        assert cand.pairing_time == 0.0
    assert cand.comm_time == cand.ring_time + cand.pairing_time


@pytest.mark.parametrize("case", [("slice", (4, 2), 8), ("slice", (2, 2, 2), 8), ("torus", (4, 2, 2), 8)])
def test_comm_time_reproduced_standalone(case):
    mode, dims, chips = case
    _, ppod = _pods(dims, mode)
    plan = tp.plan_model(TINY["tiny-moe"][1], chips, pod=ppod, shape="train_4k", wrap_mode=mode, device=CPU)
    for cand in plan.table:
        _assert_comm_reproduced(cand)


@pytest.mark.parametrize("case", [((4, 2), 4), ((4, 2), 8), ((2, 2, 2), 8)])
@pytest.mark.parametrize("cfg", sorted(TINY))
def test_simulated_slowdown_is_at_least_one_and_matches_jax(jax_profile, case, cfg):
    dims, chips = case
    got, want = _plans(cfg, dims, chips, "slice", "train_4k", simulate_top_k=10**9)
    assert _rows(got) == _rows(want)
    for a, b in zip(got.table, want.table):
        assert a.simulated_slowdown >= 1.0 - 1e-9
        assert math.isclose(a.simulated_slowdown, b.simulated_slowdown, rel_tol=1e-9)
    analytic, _ = _plans(cfg, dims, chips, "slice", "train_4k")
    assert all(c.simulated_slowdown == 1.0 for c in analytic.table)


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_traffic_match_jax_for_every_arch(jax_profile, arch):
    jc, pc = jax_get_arch(arch), port_get_arch(arch)
    assert pc.param_count() == jc.param_count()
    for chips in (4, 8, 16, 32, 64):
        want, got = jp.enumerate_rules(jc, chips), tp.enumerate_rules(pc, chips)
        assert [(r.axis_sizes, r.specs) for r in got] == [(r.axis_sizes, r.specs) for r in want]
        for rule in got:
            for shape in SHAPE_NAMES:
                entries = tp.rule_traffic(pc, tp.SHAPES[shape], rule.axis_sizes)
                assert entries == jp.rule_traffic(jc, jp.SHAPES[shape], rule.axis_sizes)
                pair = tp.pairing_stress_volume(entries, rule.axis_sizes)
                assert pair == jp.pairing_stress_volume(entries, rule.axis_sizes)
                a, b = tp.rule_rank_traffic(rule.axis_sizes, entries, pair), \
                    jp.rule_rank_traffic(rule.axis_sizes, entries, pair)
                assert (a is None) == (b is None)
                if a is not None:
                    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert tp.default_chip_budget(pc) == jp.default_chip_budget(jc)


def test_h100_profile_budgets_and_rules():
    """Under the H100 profile's 80 GB the budgets follow its own formula,
    and a rule is kept exactly when its bf16 weight shard fits 80 GB."""
    assert (h100.PEAK_FLOPS, h100.HBM_BW, h100.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    for arch in ARCHS:
        cfg = port_get_arch(arch)
        need = 2 * cfg.param_count() / 80e9
        assert tp.default_chip_budget(cfg) == max(4, 2 ** math.ceil(math.log2(max(need, 1.0))))
        rules = tp.enumerate_rules(cfg, 16)
        shard = [2.0 * cfg.param_count() / (r.axis_sizes[1] * r.axis_sizes[2] * r.axis_sizes[3]) for r in rules]
        assert all(s <= 80e9 for s in shard) or all(s > 80e9 for s in shard)


def test_to_request_carries_geometry_through_the_ports_policies():
    plan = tp.plan_model(TINY["tiny-moe"][1], 8, pod=tn.TorusFabric.tpu((4, 4), link_bw=DEFAULT_LINK_BW),
                         shape="train_4k", device=CPU)
    req = plan.to_request(job_id=3, duration=2.0, arrival=1.5)
    assert isinstance(req, tn.JobRequest)
    assert (req.job_id, req.units, req.geometry, req.duration, req.arrival) == (3, 8, plan.geometry, 2.0, 1.5)
    for policy in (tn.IsoperimetricPolicy(), tn.HintedPolicy(), tn.ContentionScoredPolicy()):
        machine = tn.MachineState((4, 4), device=CPU)
        assert policy.preferences_for(machine, req)[0] == plan.geometry
        placed = policy.allocate(machine, req)
        assert placed is not None and placed.geometry == plan.geometry


def _mesh_summary(plan):
    a = plan.assignment
    return (plan.slice_geometry, plan.slice_bisection_links, plan.worst_geometry, plan.worst_bisection_links,
            a.axis_names, a.axis_sizes, a.phys_groups, [(e.size, e.stride, e.wrapped) for e in a.embeddings],
            plan.bisection_efficiency, plan.simulated_slowdown,
            None if plan.placement is None else (plan.placement.job_id, plan.placement.geometry,
                                                 plan.placement.oriented, plan.placement.offset,
                                                 plan.placement.bisection_links,
                                                 plan.placement.predicted_contention),
            None if plan.mapping is None else (plan.mapping.strategy, plan.mapping.coords.tolist()),
            plan.mapping_congestion, plan.avoidable_contention)


def test_plan_slice_matches_jax(jax_profile):
    jpod, ppod = rn.TorusFabric.tpu((4, 4)), tn.TorusFabric.tpu((4, 4), link_bw=DEFAULT_LINK_BW)
    assert _mesh_summary(tm.plan_slice(8, ppod, device=CPU)) == _mesh_summary(jax_mesh.plan_slice(8, pod=jpod))
    got = tm.plan_slice(8, ppod, arch="mixtral-8x7b", device=CPU)
    want = jax_mesh.plan_slice(8, pod=jpod, arch="mixtral-8x7b")
    assert _mesh_summary(got) == _mesh_summary(want)
    assert _rows(got.slice_plan) == _rows(want.slice_plan)
    with pytest.raises(ValueError):
        tm.plan_slice(8, ppod, job_id=1, device=CPU)


@pytest.mark.parametrize("arch", [None, "mixtral-8x7b"])
def test_plan_slice_with_occupancy_matches_jax(jax_profile, arch):
    jpod, ppod = rn.TorusFabric.tpu((4, 4)), tn.TorusFabric.tpu((4, 4), link_bw=DEFAULT_LINK_BW)
    jstate, pstate = rn.MachineState((4, 4)), tn.MachineState((4, 4), device=CPU)
    for job in (1, 2):
        want = jax_mesh.plan_slice(8, pod=jpod, state=jstate, job_id=job, simulate=True, arch=arch)
        got = tm.plan_slice(8, ppod, state=pstate, job_id=job, simulate=True, arch=arch, device=CPU)
        assert _mesh_summary(got) == _mesh_summary(want)
    assert int(pstate.grid.sum()) == int(jstate.grid.sum()) == 16
    with pytest.raises(ValueError) as want:
        jax_mesh.plan_slice(8, pod=jpod, state=jstate)
    with pytest.raises(ValueError) as got:
        tm.plan_slice(8, ppod, state=pstate, device=CPU)
    assert str(got.value) == str(want.value)


def test_plan_axes_and_multi_pod_cost_model_match_jax():
    jpod = jax_mesh.pod_fabric()
    ppod = tn.TorusFabric(jpod.dims, jpod.wrap, jpod.link_bw, jpod.double_link_on_2)
    for axes, order in (({"data": 16, "model": 16}, None), ({"model": 16, "data": 16}, ("data",)),
                        ({"data": 16, "model": 16}, ("data", "model"))):
        a, b = tm.plan_axes(axes, order, pod=ppod), jax_mesh.plan_axes(axes, order, pod=jpod)
        assert (a.assignment.phys_groups, a.assignment.axis_names) == (b.assignment.phys_groups, b.assignment.axis_names)
        for axis in axes:
            assert a.time("all-gather", axis, 1e9) == b.time("all-gather", axis, 1e9)
    got = tm.multi_pod_cost_model({"pod": 2, "data": 16, "model": 16}, pod=ppod, dci_bw=POD_DCI_BW)
    want = jax_mesh.multi_pod_cost_model({"pod": 2, "data": 16, "model": 16})
    for key in ("ici", "dci"):
        for axis in got[key].assignment.axis_names:
            assert got[key].time("all-reduce", axis, 3e9) == want[key].time("all-reduce", axis, 3e9)
    with pytest.raises(TypeError):
        tm.multi_pod_cost_model({"pod": 2}, pod=ppod)  # the data-centre rate is required


def test_format_table_and_plan_fleet_match_jax(jax_profile):
    jpod, ppod = rn.TorusFabric.tpu((4, 2)), tn.TorusFabric.tpu((4, 2), link_bw=DEFAULT_LINK_BW)
    want = jp.plan_fleet([TINY["tiny-dense"][0], TINY["tiny-moe"][0]], chips=4, pod=jpod)
    got = tp.plan_fleet([TINY["tiny-dense"][1], TINY["tiny-moe"][1]], chips=4, pod=ppod, device=CPU)
    assert [p.arch for p in got] == ["tiny-dense", "tiny-moe"]
    for a, b in zip(got, want):
        assert tp.format_table(a) == jp.format_table(b)
        assert tp.format_table(a, top=3) == jp.format_table(b, top=3)
    mira = tp.plan_model("qwen1.5-110b", 16, pod=tp.bgq_pod("mira"), shape="train_4k", wrap_mode="torus",
                         unit_node_dims=bgq.MIDPLANE_DIMS, device=CPU)
    jmira = jp.plan_model("qwen1.5-110b", 16, pod=rn.TorusFabric.bgq(JAX_MIRA.midplane_dims, link_bw=2e9),
                          shape="train_4k", wrap_mode="torus", unit_node_dims=JAX_MIDPLANE)
    assert tp.format_table(mira) == jp.format_table(jmira)


def test_the_pod_is_required_and_hyperx_raises():
    with pytest.raises(TypeError):
        tp.plan_model(TINY["tiny-dense"][1], 4, device=CPU)
    with pytest.raises(TypeError):
        tp.plan_fleet([TINY["tiny-dense"][1]], chips=4, device=CPU)
    with pytest.raises(TypeError):
        tm.plan_slice(4)
    with pytest.raises(TypeError, match="HyperXFabric"):  # the JAX package's fabric is not a port pod
        tp.plan_model(TINY["tiny-dense"][1], 4, pod=rn.HyperXFabric((4, 4), link_bw=1.0), device=CPU)
    got = tp.plan_model(TINY["tiny-dense"][1], 4, pod=tn.HyperXFabric((4, 4), link_bw=1.0), device=CPU)
    want = jp.plan_model(TINY["tiny-dense"][0], 4, pod=rn.HyperXFabric((4, 4), link_bw=1.0))
    assert [c.geometry for c in got.table] == [c.geometry for c in want.table]
    with pytest.raises(TypeError):
        tp.plan_model(TINY["tiny-dense"][1], 4, pod=rn.TorusFabric.tpu((4, 2)), device=CPU)
    with pytest.raises(ValueError, match="wrap_mode"):
        tp.plan_model(TINY["tiny-dense"][1], 4, pod=tn.TorusFabric.tpu((4, 2), link_bw=1.0), wrap_mode="mesh",
                      device=CPU)


def test_price_spans_count_every_pricing():
    ppod = tn.TorusFabric.tpu((4, 4), link_bw=DEFAULT_LINK_BW)
    TRACER.enable(clear=True)
    try:
        plan = tp.plan_model(TINY["tiny-moe"][1], 8, pod=ppod, shape="train_4k", device=CPU)
        spans = [e for e in TRACER.events() if e["name"] == "planner.price"]
    finally:
        TRACER.disable()
        TRACER.clear()
    rules = tp.enumerate_rules(TINY["tiny-moe"][1], 8)
    geometries = tn.ranked_slice_geometries(ppod, 8, device=CPU)
    assert len(spans) == len(rules) * len(geometries)
    assert sum(1 for e in spans if e["args"]["embedded"]) == len(plan.table)


def test_cli_needs_a_pod_and_plans_without_a_model(capsys):
    from repro_torch.launch import serve, train

    with pytest.raises(SystemExit):
        serve.main(["--plan-chips", "16", "--device", "cpu"])
    assert "--plan-pod" in capsys.readouterr().err
    assert serve.build_parser().parse_args([]).plan_shape == "decode_32k"
    plan = train.main(["--arch", "mixtral-8x7b", "--plan-chips", "16", "--plan-pod", "mira", "--device", "cpu"])
    out = capsys.readouterr().out
    assert isinstance(plan, tp.SlicePlan)
    assert out.startswith("mixtral-8x7b · train_4k · 16 chips on pod (4, 4, 3, 2) (torus)")
    assert out.strip() == tp.format_table(plan)
    want = tp.plan_model("mixtral-8x7b", 16, pod=tp.bgq_pod("mira"), shape="train_4k", wrap_mode="torus",
                         unit_node_dims=bgq.MIDPLANE_DIMS, simulate_top_k=1, device=CPU)
    assert _rows(plan) == _rows(want) and plan.best.simulated_slowdown == want.best.simulated_slowdown


# What the H100 profile gives on Mira at 16 midplanes (train_4k, torus mode,
# 2 GB/s links): arch -> (best geometry, best (d,f,t,e), bisection
# efficiency, table rows).  80 GB admits rules the 16 GB filter of the JAX
# constants excludes, and mixtral's and qwen's data 4 x fsdp 4 rule then
# wins on the (4, 4, 1, 1) partition, where both axes are stride-1 wrapped
# rings; on the (2, 2, 2, 2) cube the catalogue's best mapping folds the
# data axis at stride 2.  chip_smoke.py phase 8 checks the card against
# these.
H100_MIRA_PLANS = {
    "mixtral-8x7b": ((4, 4, 1, 1), (4, 4, 1, 1), 0.5, 73),
    "qwen1.5-110b": ((4, 4, 1, 1), (4, 4, 1, 1), 0.5, 29),
    "nemotron-4-340b": ((2, 2, 2, 2), (1, 16, 1, 1), 1.0, 13),
}


@pytest.mark.parametrize("arch", sorted(H100_MIRA_PLANS))
def test_h100_profile_mira_plans(arch):
    geometry, axes, efficiency, n_rows = H100_MIRA_PLANS[arch]
    plan = tp.plan_model(arch, 16, pod=tp.bgq_pod("mira"), shape="train_4k", wrap_mode="torus",
                         unit_node_dims=bgq.MIDPLANE_DIMS, device=CPU)
    assert (plan.geometry, plan.best.axis_sizes, plan.bisection_efficiency, len(plan.table)) == \
        (geometry, axes, efficiency, n_rows)
    assert plan.table[-1].step_time / plan.step_time >= 1.3
    # fsdp over all 16 midplanes still ranks the certified cube first among its rows
    fsdp16 = [c for c in plan.table if c.axis_sizes == (1, 16, 1, 1)]
    assert fsdp16 and fsdp16[0].geometry == (2, 2, 2, 2) and fsdp16[0].bisection_efficiency == 1.0
