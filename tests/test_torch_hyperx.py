"""Parity of the port's HyperX side with the JAX package, on the CPU:
``repro_torch.network.hamming``, ``repro_torch.core.topology``,
``fabric.HyperXFabric``, the HyperX routers (against the JAX engine and
the per-hop oracle ``tests/reference_hyperx.py``), the fabric-dispatching
netsim entry points, and the HyperX branches of isoperimetry, allocation,
the scheduler, contention attribution and the planner.

Minimal loads, cut and bisection tables, the advisor's records, the queue's
event log and the planner's rows are equal bit for bit; DAL's fractional
loads within 1e-12 relative; drained makespans within 1e-9 relative.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.planner as jp  # noqa: E402
import repro.network as rn  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.analysis import roofline  # noqa: E402
from repro.core import topology as jax_topology  # noqa: E402
from repro.network import hamming as jax_hamming  # noqa: E402
from repro.network import netsim as jax_netsim  # noqa: E402
from repro.obs import contention as jax_contention  # noqa: E402
from reference_hyperx import oracle_minimal_loads  # noqa: E402

import repro_torch.launch.planner as tp  # noqa: E402
import repro_torch.network as tn  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.analysis import h100  # noqa: E402
from repro_torch.core import topology as port_topology  # noqa: E402
from repro_torch.network import hamming as port_hamming  # noqa: E402
from repro_torch.network import netsim as port_netsim  # noqa: E402

CPU = "cpu"
FABRICS = [((4, 4), None), ((16, 4), None), ((4, 3, 2), (1, 2, 1)), ((5, 3), (2, 1)), ((3, 3, 3), None), ((6,), (3,))]


def _fabrics(dims, mult=None):
    return rn.HyperXFabric(dims, mult, link_bw=1.0), tn.HyperXFabric(dims, mult, link_bw=1.0)


def as_tuple(event):
    """Every field of a scheduler record, from either package."""
    request = None if event.request is None else dataclasses.astuple(event.request)
    placement = None if event.placement is None else dataclasses.astuple(event.placement)
    return (event.time, event.kind, event.seq, event.job_id, event.cells, request, placement,
            event.priority, event.reason, event.source)


def _messages(seed, dims, n):
    rng = np.random.default_rng(seed)
    src = np.stack([rng.integers(0, a, n) for a in dims], axis=1)
    dst = np.stack([rng.integers(0, a, n) for a in dims], axis=1)
    return src, dst, rng.integers(1, 5, n).astype(np.float64)


# ---------------------------------------------------------------------------
# Hamming closed forms and core.topology.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims, mult", FABRICS, ids=str)
def test_hamming_closed_forms_equal_jax(dims, mult):
    n = int(np.prod(dims))
    assert port_hamming.hamming_degree(dims, mult) == jax_hamming.hamming_degree(dims, mult)
    assert port_hamming.hamming_num_edges(dims, mult) == jax_hamming.hamming_num_edges(dims, mult)
    assert port_hamming.hamming_bisection_links(dims, mult) == jax_hamming.hamming_bisection_links(dims, mult)
    for t in range(n + 1):
        assert np.array_equal(port_hamming.lex_cells(dims, t), jax_hamming.lex_cells(dims, t))
        for fn in ("lex_max_edges", "packed_edges_bound", "lindsey_bound", "hamming_subset_bound"):
            assert getattr(port_hamming, fn)(dims, t, mult) == getattr(jax_hamming, fn)(dims, t, mult), (fn, t)
    for sides in itertools.product(*(range(1, a + 1) for a in dims)):
        assert port_hamming.hamming_cut_aligned(dims, sides, mult) == jax_hamming.hamming_cut_aligned(dims, sides, mult)


@pytest.mark.parametrize("dims, mult", FABRICS, ids=str)
def test_hamming_cut_of_set_on_the_device_path(dims, mult):
    rng = np.random.default_rng(len(dims))
    n = int(np.prod(dims))
    cells = np.stack(np.unravel_index(np.arange(n), dims), axis=1)
    for t in (1, n // 3, n // 2, n):
        pick = cells[rng.permutation(n)[:t]]
        assert port_hamming.hamming_cut_of_set(dims, pick, mult, device=CPU) == \
            jax_hamming.hamming_cut_of_set(dims, pick, mult)
    assert port_hamming.hamming_cut_of_set(dims, np.zeros((0, len(dims)), int), mult, device=CPU) == 0
    with pytest.raises(ValueError, match="shape"):
        port_hamming.hamming_cut_of_set(dims, np.zeros((2, len(dims) + 1), int), device=CPU)
    with pytest.raises(ValueError):
        port_hamming.lindsey_bound(dims, n + 1)
    with pytest.raises(ValueError):
        port_hamming.hamming_degree(dims, (1,) * (len(dims) + 1))


def test_topology_closed_forms_equal_jax():
    for d in range(1, 6):
        assert port_topology.hypercube_bisection(d) == jax_topology.hypercube_bisection(d)
        for t in range(2 ** d + 1):
            assert port_topology.hypercube_harper_bound(d, t) == jax_topology.hypercube_harper_bound(d, t)
        for sub in itertools.product((1, 2), repeat=d):
            assert port_topology.hypercube_cuboid_cut(d, sub) == jax_topology.hypercube_cuboid_cut(d, sub)
    for sizes in [(4, 4), (6, 3, 2), (5,)]:
        a, b = port_topology.HyperX(sizes), jax_topology.HyperX(sizes)
        assert (a.clique_sizes, a.num_vertices, a.bisection_links()) == \
            (b.clique_sizes, b.num_vertices, b.bisection_links())
        for t in range(a.num_vertices + 1):
            assert a.lindsey_optimal_cut(t) == b.lindsey_optimal_cut(t)
            assert a.best_subproduct(t) == b.best_subproduct(t)
    g, h = port_topology.DragonflyGroup(), jax_topology.DragonflyGroup()
    for t in range(1, g.num_routers + 1):
        assert g.best_subgroup(t) == h.best_subgroup(t)
    assert g.weighted_cut(4, 3) == h.weighted_cut(4, 3)


# ---------------------------------------------------------------------------
# The fabric and the routers.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims, mult", FABRICS, ids=str)
def test_fabric_equals_jax(dims, mult):
    jf, pf = _fabrics(dims, mult)
    assert (pf.num_cells, pf.num_chips, pf.degree, pf.bisection_links(), pf.bisection_bandwidth()) == \
        (jf.num_cells, jf.num_chips, jf.degree, jf.bisection_links(), jf.bisection_bandwidth())
    a, b = pf.links(), jf.links()
    for name in ("link", "src", "dst", "capacity"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert a.n_slots == b.n_slots and np.array_equal(a.dense_capacities(), b.dense_capacities())
    assert np.array_equal(pf.neighbors(0), jf.neighbors(0))
    sides = tuple(max(1, x // 2) for x in dims)
    assert dataclasses.astuple(pf.sub_fabric(sides)) == dataclasses.astuple(jf.sub_fabric(sides))
    assert pf.contains_cuboid(sides) == jf.contains_cuboid(sides)


def test_fabric_validation_and_ring_refusals():
    with pytest.raises(ValueError, match="dims"):
        tn.HyperXFabric((0, 4), link_bw=1.0)
    with pytest.raises(ValueError, match="multiplicity"):
        tn.HyperXFabric((4, 4), (1,), link_bw=1.0)
    with pytest.raises(TypeError):
        tn.HyperXFabric((4, 4))  # the port carries no default link rate
    with pytest.raises(ValueError, match="does not fit"):
        tn.HyperXFabric((4, 4), link_bw=1.0).sub_fabric((8, 1))
    with pytest.raises(TypeError, match="HyperX"):
        tn.slice_fabric(tn.HyperXFabric((4, 4), link_bw=1.0), (2, 2))


@pytest.mark.parametrize("dims, mult", FABRICS, ids=str)
@pytest.mark.parametrize("mode", ["minimal", "dal"])
def test_routers_equal_jax_and_the_oracle(dims, mult, mode):
    jf, pf = _fabrics(dims, mult)
    src, dst, vol = _messages(sum(dims), dims, 150)
    want = rn.route_hyperx(jf, src, dst, vol, mode=mode)
    got = tn.route_hyperx(pf, src, dst, vol, mode=mode, device=CPU)
    if mode == "minimal":
        assert np.array_equal(got, want)
        assert np.array_equal(got, oracle_minimal_loads(jf, src, dst, vol))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.array_equal(tn.route_pattern(pf, src, dst, vol, mode=mode, device=CPU), got)
    assert tn.hyperx_max_link_load(pf, got) == pytest.approx(rn.hyperx_max_link_load(jf, want), rel=1e-12)
    paths = port_netsim.fabric_paths(pf, (src, dst, vol), mode=mode, device=CPU)
    ref = jax_netsim.fabric_paths(jf, (src, dst, vol), mode=mode)
    for name in ("msg", "link_ids", "flow_ids"):
        assert np.array_equal(getattr(paths, name), getattr(ref, name)), name
    np.testing.assert_allclose(paths.vol, ref.vol, rtol=1e-12)
    assert np.array_equal(paths.capacities, ref.capacities) and paths.mode == ref.mode


def test_dal_first_round_decisions_and_all_to_all_closed_form():
    """A steady pattern is minimal routing under DAL, bit for bit; the
    all-to-all closed form equals the routed maximum."""
    for dims, mult in [((4, 4), None), ((8, 2), (1, 2)), ((4, 3, 2), None)]:
        jf, pf = _fabrics(dims, mult)
        a2a = rn.all_to_all(dims)
        minimal = tn.route_hyperx(pf, *a2a, device=CPU)
        assert np.array_equal(tn.route_hyperx(pf, *a2a, mode="dal", device=CPU), minimal)
        assert tn.hyperx_max_link_load(pf, minimal) == tn.hyperx_all_to_all_max_load(pf) == \
            rn.hyperx_all_to_all_max_load(jf)
    hot = rn.hotspot_line((8, 4))
    jf, pf = _fabrics((8, 4))
    for rounds in (1, 3):
        np.testing.assert_allclose(tn.route_hyperx(pf, *hot, mode="dal", rounds=rounds, device=CPU),
                                   rn.route_hyperx(jf, *hot, mode="dal", rounds=rounds), rtol=1e-12)
    with pytest.raises(ValueError, match="mode"):
        tn.route_hyperx(pf, *hot, mode="valiant", device=CPU)
    with pytest.raises(ValueError, match="shape"):
        tn.route_hyperx(pf, np.zeros((2, 3), int), np.zeros((2, 3), int), 1.0, device=CPU)
    z = np.zeros((0, 2), int)
    assert not tn.route_hyperx(pf, z, z, 1.0, device=CPU).any()


@pytest.mark.parametrize("dims", [(4, 4), (16, 4), (8, 8), (4, 3, 2)], ids=str)
@pytest.mark.parametrize("pattern", ["all_to_all", "hotspot_line", "pairing"])
def test_fabric_routing_comparison_equals_jax(dims, pattern):
    jf, pf = _fabrics(dims)
    traffic = {"all_to_all": rn.all_to_all, "hotspot_line": rn.hotspot_line,
               "pairing": rn.bisection_pairing}[pattern](dims)
    want = rn.compare_fabric_routing(jf, traffic)
    got = tn.compare_fabric_routing(pf, traffic, device=CPU)
    assert got.dims == want.dims
    np.testing.assert_allclose([got.dor_makespan, got.adaptive_makespan],
                               [want.dor_makespan, want.adaptive_makespan], rtol=1e-9)
    if pattern == "all_to_all":
        assert got.recovered_fraction == 0.0
    for mode in ("minimal", "dal"):
        a = tn.simulate_fabric_traffic(pf, traffic, mode=mode, device=CPU)
        b = rn.simulate_fabric_traffic(jf, traffic, mode=mode)
        assert a.steps == b.steps and a.mode == b.mode
        np.testing.assert_allclose(a.completion, b.completion, rtol=1e-9)


def test_torus_fabrics_dispatch_to_the_torus_routers():
    traffic = rn.hotspot_line((8, 4))
    torus = tn.TorusFabric.bgq((8, 4), link_bw=1.0)
    a = tn.compare_fabric_routing(torus, traffic, device=CPU)
    b = tn.compare_routing((8, 4), traffic, device=CPU)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert np.array_equal(port_netsim.fabric_paths((8, 4), traffic, device=CPU).link_ids,
                          tn.dor_paths((8, 4), *traffic).link_ids)


# ---------------------------------------------------------------------------
# Isoperimetry, allocation, the scheduler, attribution and the planner.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims, mult", FABRICS[:4], ids=str)
def test_isoperimetry_branches_equal_jax(dims, mult):
    jf, pf = _fabrics(dims, mult)
    n = int(np.prod(dims))
    for t in range(1, n + 1):
        assert tn.cut_table(pf, t, device=CPU).items() == rn.cut_table(jf, t).items()
        for fn in ("optimal_cuboid", "worst_cuboid"):
            a, b = getattr(tn, fn)(pf, t, device=CPU), getattr(rn, fn)(jf, t)
            assert (a is None) == (b is None) and (a is None or dataclasses.astuple(a) == dataclasses.astuple(b))
        try:
            want = rn.bisection_table(jf, t)
        except ValueError:
            with pytest.raises(ValueError):
                tn.bisection_table(pf, t, device=CPU)
            continue
        got = tn.bisection_table(pf, t, device=CPU)
        assert got.ranked() == want.ranked() and got.best() == want.best() and got.worst() == want.worst()
        assert tn.ranked_geometries(pf, t, device=CPU) == rn.ranked_geometries(jf, t)
        a, b = tn.advise_partition(pf, t, simulate=True, device=CPU), rn.advise_partition(jf, t, simulate=True)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    with pytest.raises(ValueError, match="unit_node_dims"):
        tn.bisection_table(pf, 2, unit_node_dims=(2, 2), device=CPU)
    with pytest.raises(TypeError, match="torus-only"):
        tn.small_set_expansion(pf, 2, device=CPU)


def test_advisor_doctests_and_table_on_the_pod():
    jf, pf = _fabrics((16, 4))
    a, b = tn.advise_partition(pf, 16, (4, 4), device=CPU), rn.advise_partition(jf, 16, (4, 4))
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert (a.optimal_geometry, a.current_bisection, a.optimal_bisection, a.predicted_speedup, a.certified) == \
        ((16, 1), 16, 64, 4.0, True)
    table = {4: (2, 2), 8: (4, 2), 16: (4, 4), 32: (8, 4)}
    got = tn.advise_policy_table(pf, table, device=CPU)
    want = rn.advise_policy_table(jf, table)
    assert [dataclasses.astuple(x) for x in got] == [dataclasses.astuple(x) for x in want]
    assert tn.is_isoperimetrically_optimal(pf, (16, 1), device=CPU) is True


def test_machine_state_box_closure_and_refusals():
    jf, pf = _fabrics((16, 4))
    jm, pm = rn.MachineState(jf), tn.MachineState(pf, device=CPU)
    for m in (jm, pm):
        assert m.allocate(1, (4, 2)) is not None and m.allocate_scored(2, (8, 2)) is not None
    assert [dataclasses.astuple(p) for p in pm.placements.values()] == \
        [dataclasses.astuple(p) for p in jm.placements.values()]
    assert pm.placements[2].bisection_links == pf.sub_fabric((8, 2)).bisection_links()
    assert pm.fabric_or_dims is pf and pm.is_hyperx
    with pytest.raises(TypeError, match="share no links"):
        pm.traffic_loads()
    pm.release(1)
    assert pm.free_units == 64 - 16
    rep = obs.attribute_contention(pm)
    assert all(j.cross_load == 0.0 and j.self_load > 0 for j in rep.jobs)
    with pytest.raises(TypeError):
        tn.MachineState(jf, device=CPU)  # the JAX package's fabric is not the port's


@pytest.mark.parametrize("name", ["isoperimetric", "elongated", "contention-scored", "hinted"])
def test_simulate_queue_event_log_equals_jax(name):
    jf, pf = _fabrics((16, 4))
    pol = {"isoperimetric": "IsoperimetricPolicy", "elongated": "ElongatedPolicy",
           "contention-scored": "ContentionScoredPolicy", "hinted": "HintedPolicy"}[name]
    rng = np.random.default_rng(3)
    spec = [(i, int(rng.choice([2, 4, 8, 16])), float(rng.uniform(1, 5)), float(i) * 0.5) for i in range(20)]
    want = rn.simulate_queue(jf, [rn.JobRequest(i, u, duration=d, arrival=t) for i, u, d, t in spec],
                             getattr(rn, pol)(), backfill=True)
    got = tn.simulate_queue(pf, [tn.JobRequest(i, u, duration=d, arrival=t) for i, u, d, t in spec],
                            getattr(tn, pol)(), backfill=True, device=CPU)
    assert [(j.request.job_id, j.start, j.end, j.predicted_comm_time, j.bisection_efficiency,
             dataclasses.astuple(j.placement)) for j in got.jobs] == \
        [(j.request.job_id, j.start, j.end, j.predicted_comm_time, j.bisection_efficiency,
          dataclasses.astuple(j.placement)) for j in want.jobs]
    assert got.rejected == want.rejected


def test_scheduler_branches_and_refusals():
    jf, pf = _fabrics((16, 4))
    jobs = [(0, 16, (16, 1)), (1, 16, (8, 2))]
    res = tn.simulate_queue(pf, [tn.JobRequest(i, u, duration=1.0, geometry=g) for i, u, g in jobs],
                            tn.IsoperimetricPolicy(), device=CPU)
    by_id = {j.request.job_id: j for j in res.jobs}
    assert by_id[1].predicted_comm_time / by_id[0].predicted_comm_time == 8.0
    svc_p = tn.SchedulerService(pf, tn.IsoperimetricPolicy(), device=CPU)
    svc_j = rn.SchedulerService(jf, rn.IsoperimetricPolicy())
    for svc, pkg in ((svc_p, tn), (svc_j, rn)):
        for i in range(6):
            svc.submit(pkg.JobRequest(i, 16, duration=2.0, arrival=float(i)))
        svc.run()
    assert [as_tuple(e) for e in svc_p.log] == [as_tuple(e) for e in svc_j.log]
    assert obs.scheduler_metrics(svc_p).snapshot() == jax_obs.scheduler_metrics(svc_j).snapshot()
    reqs = [tn.JobRequest(0, 16, duration=1.0)]
    with pytest.raises(ValueError):
        tn.simulate_queue(pf, reqs, tn.IsoperimetricPolicy(), measure_contention=True, device=CPU)
    with pytest.raises(ValueError):
        tn.simulate_queue(pf, reqs, tn.IsoperimetricPolicy(), unit_node_dims=(2, 2), device=CPU)


def test_hyperx_attribution_equals_jax():
    jf, pf = _fabrics((8, 4), (1, 2))
    jm, pm = rn.MachineState(jf), tn.MachineState(pf, device=CPU)
    for m in (jm, pm):
        m.allocate(1, (4, 2))
        m.allocate(2, (8, 2))
        m.allocate(3, (2, 1))
    for top in (0, 5):
        want = jax_contention.attribute_contention(jm, top_hotspots=top)
        got = obs.attribute_contention(pm, top_hotspots=top)
        assert [dataclasses.astuple(a) for a in got.jobs] == [dataclasses.astuple(b) for b in want.jobs]
        assert (got.total_load, got.max_link_load, got.cross_load) == \
            (want.total_load, want.max_link_load, want.cross_load)
        assert [h.load for h in got.hotspots] == [h.load for h in want.hotspots]
        if top == 0:
            assert obs.render_dashboard(got) == jax_contention.render_dashboard(want)
    loads = {j: tn.route_hyperx(pf, *rn.all_to_all((8, 4)), device=CPU) for j in (0,)}
    with pytest.raises(ValueError, match="shape"):
        obs.attribute_traffic((8, 4), {0: np.zeros(5)}, fabric=pf, device=CPU)
    only = obs.attribute_traffic((8, 4), loads, fabric=pf, device=CPU)
    assert only.jobs[0].self_load == float(loads[0].sum()) and only.hotspots


def _set_jax_profile(mp):
    mp.setattr(h100, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    mp.setattr(h100, "HBM_BW", roofline.HBM_BW)
    mp.setattr(h100, "HBM_BYTES", jp.HBM_BYTES)


@pytest.mark.parametrize("arch, chips, pod", [("mixtral-8x7b", 16, ((16, 4), None)), ("granite-3-8b", 8, ((4, 4), (1, 2))),
                                              ("qwen1.5-110b", 16, ((8, 4), None))], ids=str)
def test_planner_rows_on_a_hyperx_pod_equal_jax(monkeypatch, arch, chips, pod):
    _set_jax_profile(monkeypatch)
    jf, pf = _fabrics(*pod)
    for shape in ("train_4k", "decode_32k"):
        want = jp.plan_model(arch, chips, pod=jf, shape=shape, simulate_top_k=1)
        got = tp.plan_model(arch, chips, pod=pf, shape=shape, simulate_top_k=1, device=CPU)
        assert [c.row() for c in got.table] == [c.row() for c in want.table]
        assert [(c.bisection_links, c.bisection_efficiency, c.simulated_slowdown) for c in got.table] == \
            [(c.bisection_links, c.bisection_efficiency, c.simulated_slowdown) for c in want.table]
        assert tp.format_table(got) == jp.format_table(want)
    assert {c.geometry for c in got.table} == {c.geometry for c in want.table}
    with pytest.raises(ValueError, match="unit_node_dims"):
        tp.plan_model(arch, chips, pod=pf, wrap_mode="torus", unit_node_dims=(2, 2), device=CPU)
    with pytest.raises(ValueError, match="wrap_mode"):
        tp.plan_model(arch, chips, pod=pf, wrap_mode="mesh", device=CPU)
