"""Parity of the port's isoperimetry engine and partition advisor
(``repro_torch.network.isoperimetry``), its geometry, fabric, routing
closed forms, prediction validation and Blue Gene/Q tables
(``repro_torch.core.bgq``) with the JAX package, on the CPU.

``PartitionAdvice`` fields are equal for every size of Mira's scheduler
table and JUQUEEN's partition sizes; with ``simulate=True`` the drained
ratio equals the JAX package's NumPy and ``xla`` engines'.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.core import bgq as jax_bgq  # noqa: E402
from repro.network import fabric as jax_fabric  # noqa: E402
from repro.network import geometry as jax_geometry  # noqa: E402
from repro.network import isoperimetry as jax_iso  # noqa: E402
from repro.network import routing as jax_routing  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import bgq  # noqa: E402
from repro_torch.network import fabric as port_fabric  # noqa: E402
from repro_torch.network import geometry as port_geometry  # noqa: E402
from repro_torch.network import isoperimetry as port_iso  # noqa: E402
from repro_torch.network import routing as port_routing  # noqa: E402

CPU = "cpu"
UNIT = (4, 4, 4, 4, 2)
JUQUEEN_WORST = {mp: jax_bgq.JUQUEEN.worst_partition(mp)[0] for mp in jax_bgq.JUQUEEN.partition_sizes()}
TABLES = {
    "mira": (jax_bgq.MIRA.midplane_dims, jax_bgq.MIRA_SCHEDULER_PARTITIONS),
    "juqueen": (jax_bgq.JUQUEEN.midplane_dims, JUQUEEN_WORST),
}


@pytest.mark.parametrize("machine", sorted(TABLES))
@pytest.mark.parametrize("unit", [UNIT, None], ids=["nodes", "midplanes"])
def test_advise_policy_table_matches_jax(machine, unit):
    dims, table = TABLES[machine]
    if unit is None:  # one midplane has no pairing traffic: 0 / 0 in both packages
        table = {s: g for s, g in table.items() if s > 1}
    got = tn.advise_policy_table(dims, table, unit_node_dims=unit, device=CPU)
    want = rn.advise_policy_table(dims, table, unit_node_dims=unit)
    assert [dataclasses.astuple(a) for a in got] == [dataclasses.astuple(a) for a in want]
    for a, b in zip(got, want):
        assert (a.bisection_efficiency, a.is_current_optimal, a.certified) == \
            (b.bisection_efficiency, b.is_current_optimal, b.certified)
    worst = [tn.advise_partition(dims, s, unit_node_dims=unit, device=CPU) for s in sorted(table)]
    assert [dataclasses.astuple(a) for a in worst] == \
        [dataclasses.astuple(rn.advise_partition(dims, s, unit_node_dims=unit)) for s in sorted(table)]


@pytest.mark.parametrize("machine, sizes", [("mira", [2, 4]), ("juqueen", [4, 7])])
def test_advisor_simulation_matches_numpy_and_xla(machine, sizes):
    dims, table = TABLES[machine]
    got = tn.advise_policy_table(dims, table, unit_node_dims=UNIT, simulate=True, sizes=sizes, device=CPU)
    for backend in (None, "xla"):
        want = rn.advise_policy_table(dims, table, unit_node_dims=UNIT, simulate=True, sizes=sizes, backend=backend)
        for a, b in zip(got, want):
            assert dataclasses.astuple(dataclasses.replace(a, simulated_speedup=None)) == \
                dataclasses.astuple(dataclasses.replace(b, simulated_speedup=None))
            np.testing.assert_allclose(a.simulated_speedup, b.simulated_speedup, rtol=1e-9, atol=1e-12)
            assert a.simulated_speedup == a.predicted_speedup
    assert [a.units for a in got] == sizes


def test_mira_table1_ratios():
    """The paper's Table 1: Mira's current geometries at 4, 8, 16 and 24
    midplanes against the optimum."""
    advice = tn.advise_policy_table(bgq.MIRA.midplane_dims, bgq.MIRA_SCHEDULER_PARTITIONS,
                                    unit_node_dims=UNIT, sizes=[4, 8, 16, 24], device=CPU)
    assert [a.predicted_speedup for a in advice] == [2.0, 2.0, 2.0, 1.3333333333333333]
    assert [a.optimal_geometry for a in advice] == [bgq.MIRA_PROPOSED_PARTITIONS[s] for s in (4, 8, 16, 24)]


@pytest.mark.parametrize("dims", [(4, 4, 4), (6, 4, 2), (4, 4, 3, 2), (7, 2, 2, 2), (5, 3)])
def test_bisection_tables_and_cuboids_match_jax(dims):
    n = int(np.prod(dims))
    for units in range(1, n + 1):
        try:
            want = jax_iso.bisection_table(dims, units)
        except ValueError:
            with pytest.raises(ValueError, match="no cuboid"):
                port_iso.bisection_table(dims, units, device=CPU)
            continue
        got = port_iso.bisection_table(dims, units, device=CPU)
        assert got.ranked() == want.ranked() and got.best() == want.best() and got.worst() == want.worst()
        assert port_iso.ranked_geometries(dims, units, device=CPU) == jax_iso.ranked_geometries(dims, units)
        g = want.best()[0]
        assert port_iso.is_isoperimetrically_optimal(dims, g, device=CPU) == jax_iso.is_isoperimetrically_optimal(dims, g)
        assert got.bisection_of(g) == want.bisection_of(g)
        for fn in ("optimal_cuboid", "worst_cuboid"):
            a, b = getattr(port_iso, fn)(dims, units, device=CPU), getattr(jax_iso, fn)(dims, units)
            assert (a is None and b is None) or dataclasses.astuple(a) == dataclasses.astuple(b)
        assert np.array_equal(port_iso.fitting_geometries(dims, units, device=CPU), jax_iso.fitting_geometries(dims, units))
    assert port_iso.small_set_expansion(dims, n // 2, device=CPU) == jax_iso.small_set_expansion(dims, n // 2)
    assert port_iso.bisection_of_geometry(dims, device=CPU) == jax_iso.bisection_of_geometry(dims)
    for r in range(len(dims)):
        for t in (1, 2, 4, n // 2):
            assert port_iso.lemma32_cut(dims, t, r) == jax_iso.lemma32_cut(dims, t, r)


def test_bounds_and_node_scaling_match_jax():
    for n, D in ((4, 2), (6, 3), (8, 4)):
        for t in range(0, n**D // 2 + 1, max(1, n**D // 16)):
            assert port_iso.bollobas_leader_bound(n, D, t) == jax_iso.bollobas_leader_bound(n, D, t)
    for g in ((4, 1, 1, 1), (2, 2, 2, 1), (7, 2, 2, 2), (3,)):
        assert port_iso.scaled_node_dims(g, UNIT) == jax_iso.scaled_node_dims(g, UNIT)
    for package in (port_iso, jax_iso):
        with pytest.raises(ValueError, match="fewer dims"):
            package.scaled_node_dims((2, 2, 2), (4, 4))
        with pytest.raises(ValueError, match="t must satisfy"):
            package.bollobas_leader_bound(4, 2, 9)


def test_geometry_and_fabric_match_jax():
    for dims in ((4, 4, 4), (6, 4, 2), (7, 2, 2, 2), (16, 16, 12, 8, 2), (5, 3, 1)):
        for name in ("bisection_links", "degree", "num_edges"):
            assert getattr(port_geometry, name)(dims) == getattr(jax_geometry, name)(dims)
        for size in (1, 2, 4, 6, 8, 12):
            assert list(port_geometry.sub_cuboids(dims, size)) == list(jax_geometry.sub_cuboids(dims, size))
            assert port_geometry.all_divisor_geometries(size, len(dims)) == jax_geometry.all_divisor_geometries(size, len(dims))
            for c in port_geometry.sub_cuboids(dims, size):
                assert port_geometry.cuboid_cut(dims, c) == jax_geometry.cuboid_cut(dims, c)
                assert port_geometry.cuboid_interior(dims, c) == jax_geometry.cuboid_interior(dims, c)
        n = int(np.prod(dims))
        assert port_geometry.theorem31_bound(dims, n // 2) == jax_geometry.theorem31_bound(dims, n // 2)
        for wrap in (None, (True,) * (len(dims) - 1) + (False,)):
            a = port_fabric.TorusFabric.tpu(dims, wrap, link_bw=2.0)
            b = jax_fabric.TorusFabric.tpu(dims, wrap, link_bw=2.0)
            assert (a.bisection_links(), a.bisection_bandwidth(), a.is_fully_wrapped) == \
                (b.bisection_links(), b.bisection_bandwidth(), b.is_fully_wrapped)
        a, b = port_fabric.TorusFabric.bgq(dims, 3.0), jax_fabric.TorusFabric.bgq(dims, 3.0)
        assert a.bisection_links() == b.bisection_links()
        la, lb = a.links(), b.links()
        for f in ("link", "src", "dst", "capacity"):
            assert np.array_equal(getattr(la, f), getattr(lb, f))
        assert np.array_equal(la.dense_capacities(), lb.dense_capacities())
        assert np.array_equal(a.neighbors(0), b.neighbors(0))
        t, u = port_fabric.Torus(dims), jax_fabric.Torus(dims)
        assert (t.D, t.num_vertices, t.degree, t.num_edges, t.bisection_links()) == \
            (u.D, u.num_vertices, u.degree, u.num_edges, u.bisection_links())
    assert port_geometry.cuboid_cut_aligned((4, 4, 2), (2, 4)) == jax_geometry.cuboid_cut_aligned((4, 4, 2), (2, 4))
    assert list(port_geometry.enumerate_vertices((2, 3))) == list(jax_geometry.enumerate_vertices((2, 3)))
    assert not port_geometry.contains_cuboid((4, 4), (5, 1)) and port_geometry.contains_cuboid((4, 4), (4, 2))
    with pytest.raises(TypeError):
        port_fabric.TorusFabric.tpu((4, 4))  # the port has no default link rate


def test_bgq_tables_match_jax():
    assert bgq.mira_partition_table() == jax_bgq.mira_partition_table()
    assert bgq.juqueen_partition_table() == jax_bgq.juqueen_partition_table()
    assert bgq.machine_design_table() == jax_bgq.machine_design_table()
    for name, m in bgq.MACHINES.items():
        j = jax_bgq.MACHINES[name]
        assert (m.midplane_dims, m.num_nodes, m.node_dims, m.machine_bisection_links()) == \
            (j.midplane_dims, j.num_nodes, j.node_dims, j.machine_bisection_links())
    assert bgq.MIRA_SCHEDULER_PARTITIONS == jax_bgq.MIRA_SCHEDULER_PARTITIONS
    assert bgq.MIRA_PROPOSED_PARTITIONS == jax_bgq.MIRA_PROPOSED_PARTITIONS
    assert bgq.partition_bisection_links((3, 2, 2, 2)) == jax_bgq.partition_bisection_links((3, 2, 2, 2))


def test_routing_closed_forms_and_validation_match_jax():
    for dims in ((4, 4), (16, 16, 12, 8, 2), (28, 8, 8, 8, 2), (5, 3), (2, 2)):
        for split in (True, False):
            for double in (True, False):
                assert port_routing.all_to_all_max_load(dims, 1.5, split, double) == \
                    jax_routing.all_to_all_max_load(dims, 1.5, split, double)
                off = tuple(a // 2 for a in dims)
                assert port_routing.uniform_offset_max_load(dims, off, 2.0, split, double) == \
                    jax_routing.uniform_offset_max_load(dims, off, 2.0, split, double)
        p, q = port_routing.predict_pairing_time(dims, 1.0, 2.0), jax_routing.predict_pairing_time(dims, 1.0, 2.0)
        assert dataclasses.astuple(p) == dataclasses.astuple(q)
    assert port_routing.pairing_speedup((16, 4, 4, 4, 2), (8, 8, 4, 4, 2)) == \
        jax_routing.pairing_speedup((16, 4, 4, 4, 2), (8, 8, 4, 4, 2))
    dims = (4, 6)
    traffic = rn.bisection_pairing(dims)
    triples = list(zip(map(tuple, traffic[0]), map(tuple, traffic[1]), traffic[2]))
    a = port_routing.simulate_pattern(dims, triples, device=CPU)
    b = jax_routing.simulate_pattern(dims, triples)
    assert np.array_equal(a.load_array(), b.load_array()) and a.max_load() == b.max_load()
    assert a.total_hop_volume() == b.total_hop_volume()
    a.add_path((0, 0), (2, 3), 1.0)
    b.add_path((0, 0), (2, 3), 1.0)
    assert all(np.array_equal(x, y) for xs, ys in zip(a.loads, b.loads) for x, y in zip(xs, ys))
    fab = tn.TorusFabric.bgq(dims, 1.0)
    assert np.array_equal(port_routing.route_pattern(fab, traffic[0], traffic[1], 1.0, device=CPU),
                          jax_routing.route_pattern(rn.TorusFabric.bgq(dims), traffic[0], traffic[1], 1.0))
    with pytest.raises(ValueError, match="mode='dor'"):
        port_routing.route_pattern(dims, traffic[0], traffic[1], 1.0, mode="dal", device=CPU)
    hx = tn.HyperXFabric(dims, link_bw=1.0)
    assert np.array_equal(port_routing.route_pattern(hx, traffic[0], traffic[1], 1.0, device=CPU),
                          jax_routing.route_pattern(rn.HyperXFabric(dims), traffic[0], traffic[1], 1.0))
    with pytest.raises(ValueError):
        port_routing.route_pattern(tn.HyperXFabric((4, 4), link_bw=1.0), traffic[0], traffic[1], 1.0, device=CPU)
    with pytest.raises(TypeError):
        port_routing.route_pattern(rn.HyperXFabric((4, 4)), traffic[0], traffic[1], 1.0, device=CPU)
    for pattern in (rn.bisection_pairing((4, 6)), rn.nearest_neighbor_halo((4, 6))):
        v, w = tn.validate_prediction(dims, pattern, device=CPU), rn.validate_prediction(dims, pattern)
        assert (v.predicted_time, v.matched, v.bounded) == (w.predicted_time, w.matched, w.bounded)
        np.testing.assert_allclose(v.simulated_time, w.simulated_time, rtol=1e-9, atol=1e-12)
        assert v.ratio == pytest.approx(w.ratio, rel=1e-9)


def test_hyperx_is_refused_by_the_engines():
    """The JAX package's HyperX fabric is refused (it is not the port's);
    the port's own runs the HyperX branches, equal to the JAX package."""
    hx = rn.HyperXFabric((4, 4))
    for call in (lambda: tn.advise_partition(hx, 4, device=CPU), lambda: tn.bisection_table(hx, 4, device=CPU),
                 lambda: tn.MachineState(hx, device=CPU)):
        with pytest.raises(TypeError):
            call()
    phx = tn.HyperXFabric((4, 4), link_bw=1.0)
    assert dataclasses.astuple(tn.advise_partition(phx, 4, device=CPU)) == dataclasses.astuple(rn.advise_partition(hx, 4))
    assert tn.bisection_table(phx, 4, device=CPU).ranked() == rn.bisection_table(hx, 4).ranked()
    assert tn.MachineState(phx, device=CPU).allocate(0, (4, 1)).bisection_links == \
        rn.MachineState(hx).allocate(0, (4, 1)).bisection_links


def test_tracer_records_and_exports(tmp_path):
    obs.enable_tracing(clear=True)
    try:
        with obs.trace("outer", k=1) as span:
            span.annotate(x=2).annotate(n=3)
            with obs.timer("inner") as t:
                pass
    finally:
        obs.disable_tracing()
    assert obs.tracing_enabled() is False and t.elapsed >= 0.0
    events = obs.export_chrome_trace(str(tmp_path / "trace.json"))["traceEvents"]
    assert [e["name"] for e in events] == ["outer", "inner"]
    assert events[0]["args"] == {"k": 1, "x": 2, "n": 3}
    with obs.trace("off"):
        pass
    assert len(obs.TRACER.events()) == 2
    assert (tmp_path / "trace.json").read_text().startswith("{")


@pytest.mark.parametrize("name", ["advise_partition", "bisection_table", "ranked_geometries", "validate_prediction"])
def test_default_device_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "advise_partition": lambda: tn.advise_partition((4, 4, 3, 2), 4),
        "bisection_table": lambda: tn.bisection_table((4, 4), 4),
        "ranked_geometries": lambda: tn.ranked_geometries((4, 4), 4),
        "validate_prediction": lambda: tn.validate_prediction((4, 4), tn.bisection_pairing((4, 4))),
    }[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call()


@pytest.mark.parametrize("dims", [(4,), (5, 3), (4, 2, 3), (2, 2, 2), (6, 2, 1, 3)])
def test_explicit_torus_matches_jax(dims):
    """``ExplicitTorus``, the brute-force oracle, equals the JAX package's:
    edge list (double links on length-2 dimensions), and the cut and
    interior of aligned cuboids and of random vertex sets, which equal
    the closed forms on the cuboids."""
    got, want = tn.ExplicitTorus(dims), rn.ExplicitTorus(dims)
    assert got._edges == want._edges and got.num_edges == want.num_edges == tn.num_edges(dims)
    assert got.num_vertices == want.num_vertices
    rng = np.random.default_rng(sum(dims))
    verts = list(port_geometry.enumerate_vertices(dims))
    for cuboid in port_geometry.sub_cuboids(dims, max(1, len(verts) // 2)):
        oriented = next(p for p in itertools.permutations(cuboid) if all(s <= a for s, a in zip(p, dims)))
        cells = got.cuboid_vertices(oriented)
        assert cells == want.cuboid_vertices(oriented)
        assert got.cut(cells) == want.cut(cells) == tn.cuboid_cut_aligned(dims, oriented)
        assert got.interior(cells) == want.interior(cells)
    for _ in range(5):
        subset = [verts[i] for i in rng.choice(len(verts), size=len(verts) // 3, replace=False)]
        assert got.cut(subset) == want.cut(subset) and got.interior(subset) == want.interior(subset)
    with pytest.raises(ValueError):
        got.cuboid_vertices(tuple(a + 1 for a in dims))
