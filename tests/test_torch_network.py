"""Parity of the port's network passes (``repro_torch.network``) with the
JAX package's NumPy engines and its ``xla`` backend, on the CPU.

Mirrors ``tests/test_backend.py``'s contracts, with the same strategies
and sizes (random fabrics up to 4D with sides 1-5, integer volumes where
exactness is meaningful):

    route_dor                   exactly equal link loads
    dor_paths                   equal fields
    simulate_flows / drain      completions within 1e-9 relative, equal steps
    drain_batch                 each lane equal to drain, bit for bit
    score_candidates            row-exact against score_mapping
    contention_field            within 1e-9 x max(1, max|field|), the same
                                best offset after 9-decimal rounding
    cut_table                   int64 identical

The ``xla`` backend enables ``jax_enable_x64`` for the whole process on
first use (``repro.network.backend._jax``), as ``tests/test_backend.py``
does; these parity tests therefore live in a file of their own.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.core import bgq  # noqa: E402
from repro.network import backend as jax_backend  # noqa: E402
from repro.network import placement as jax_placement  # noqa: E402
from repro.network import routing as jax_routing  # noqa: E402
from repro.network.fabric import HyperXFabric, TorusFabric  # noqa: E402
from repro.network.mapping import pattern_traffic as jax_pattern_traffic  # noqa: E402
from repro.network.mapping import score_mapping as jax_score_mapping  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch.interop import flow_paths_from_numpy  # noqa: E402
from repro_torch.network import mapping as port_mapping  # noqa: E402
from repro_torch.network import patterns as port_patterns  # noqa: E402
from repro_torch.network import placement as port_placement  # noqa: E402
from repro_torch.obs import DISPATCHES  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its phase 6 tables; it imports torch only when run)

needs_jax = pytest.mark.skipif(not rn.HAVE_JAX, reason="jax not installed")

CPU = "cpu"
dims_strategy = st.lists(st.integers(1, 5), min_size=1, max_size=4).map(tuple)


def _random_messages(seed, dims, n_msgs):
    rng = np.random.default_rng(seed)
    src = np.stack([rng.integers(0, a, n_msgs) for a in dims], axis=1)
    dst = np.stack([rng.integers(0, a, n_msgs) for a in dims], axis=1)
    vol = rng.integers(1, 5, n_msgs).astype(np.float64)
    return src, dst, vol


def _assert_drains_match(res, ref):
    scale = max(ref.makespan, 1.0)
    assert abs(res.makespan - ref.makespan) <= 1e-9 * scale
    np.testing.assert_allclose(res.flow_completion, ref.flow_completion, rtol=1e-9, atol=1e-12)
    assert res.steps == ref.steps


# ---------------------------------------------------------------------------
# Route loads.
# ---------------------------------------------------------------------------
@needs_jax
@settings(max_examples=10, deadline=None)
@given(
    dims=dims_strategy,
    seed=st.integers(0, 2**31 - 1),
    n_msgs=st.integers(1, 24),
    split_ties=st.sampled_from([True, False]),
)
def test_route_dor_exact(dims, seed, n_msgs, split_ties):
    src, dst, vol = _random_messages(seed, dims, n_msgs)
    port = tn.route_dor(dims, src, dst, vol, split_ties=split_ties, device=CPU)
    assert port.shape == (len(dims), 2) + dims and port.dtype == np.float64
    assert np.array_equal(port, rn.route_dor(dims, src, dst, vol, split_ties=split_ties))
    assert np.array_equal(port, rn.route_dor(dims, src, dst, vol, split_ties=split_ties, backend="xla"))


@needs_jax
def test_route_dor_empty_and_scalar_vol():
    empty = np.zeros((0, 2), dtype=np.int64)
    out = tn.route_dor((4, 3), empty, empty, np.zeros(0), device=CPU)
    assert out.shape == (2, 2, 4, 3) and not out.any()
    src, dst, _ = _random_messages(7, (4, 3), 5)
    port = tn.route_dor((4, 3), src, dst, 2.0, device=CPU)
    assert np.array_equal(port, rn.route_dor((4, 3), src, dst, 2.0))
    assert np.array_equal(port, rn.route_dor((4, 3), src, dst, 2.0, backend="xla"))
    with pytest.raises(ValueError, match="shape"):
        tn.route_dor((4, 3), src, dst[:, :1], 1.0, device=CPU)


def test_max_link_load_matches():
    dims = (4, 2, 3)
    src, dst, vol = _random_messages(5, dims, 16)
    loads = tn.route_dor(dims, src, dst, vol, device=CPU)
    for double in (True, False):
        assert tn.max_link_load(dims, loads, double) == jax_routing.max_link_load(dims, loads, double)


# ---------------------------------------------------------------------------
# Paths and the drain.
# ---------------------------------------------------------------------------
@settings(max_examples=10, deadline=None)
@given(
    dims=dims_strategy,
    seed=st.integers(0, 2**31 - 1),
    n_msgs=st.integers(1, 24),
    split_ties=st.sampled_from([True, False]),
)
def test_dor_paths_fields_equal(dims, seed, n_msgs, split_ties):
    src, dst, vol = _random_messages(seed, dims, n_msgs)
    port = tn.dor_paths(dims, src, dst, vol, split_ties=split_ties)
    ref = rn.dor_paths(dims, src, dst, vol, split_ties=split_ties)
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, f.name
    assert np.array_equal(port.link_loads(), ref.link_loads())
    assert port.max_link_load() == ref.max_link_load()


@needs_jax
@settings(max_examples=6, deadline=None)
@given(
    dims=st.lists(st.integers(2, 4), min_size=2, max_size=3).map(tuple),
    seed=st.integers(0, 2**31 - 1),
    n_msgs=st.integers(1, 12),
)
def test_simulate_flows_matches_numpy_and_xla(dims, seed, n_msgs):
    src, dst, vol = _random_messages(seed, dims, n_msgs)
    paths = tn.dor_paths(dims, src, dst, vol)
    res = tn.simulate_flows(paths, device=CPU)
    jpaths = rn.dor_paths(dims, src, dst, vol)
    for ref in (rn.simulate_flows(jpaths), rn.simulate_flows(jpaths, backend="xla")):
        assert np.array_equal(res.link_loads, ref.link_loads)
        _assert_drains_match(res, ref)
        np.testing.assert_allclose(res.completion, ref.completion, rtol=1e-9, atol=1e-12)
        assert res.ideal_time == ref.ideal_time and res.slowdown == pytest.approx(ref.slowdown, rel=1e-9)


@needs_jax
@pytest.mark.parametrize("seed", [0, 1])
def test_drain_with_float_volumes_matches_numpy(seed):
    """Volumes with no exact float64 sums: the same completion order and
    steps, completions within 1e-9."""
    dims = (4, 4, 3)
    rng = np.random.default_rng(seed)
    src, dst, _ = _random_messages(seed, dims, 40)
    vol = rng.random(40) * 3.0 + 0.1
    res = tn.simulate_flows(tn.dor_paths(dims, src, dst, vol), device=CPU)
    jpaths = rn.dor_paths(dims, src, dst, vol)
    _assert_drains_match(res, rn.simulate_flows(jpaths))
    _assert_drains_match(res, rn.simulate_flows(jpaths, backend="xla"))


@needs_jax
def test_drain_batch_lanes_match_single_drains():
    paths = tn.dor_paths((4, 4, 2), *tn.bisection_pairing((4, 4, 2)))
    plan = tn.prepare_drain(paths, device=CPU)
    jplan = jax_backend.prepare_drain(rn.dor_paths((4, 4, 2), *rn.bisection_pairing((4, 4, 2))))
    rng = np.random.default_rng(3)
    vols = rng.integers(1, 4, size=(4, plan.n_flows)).astype(np.float64)
    fc_b, steps_b = tn.drain_batch(plan, vols)
    assert fc_b.shape == vols.shape and steps_b.dtype == np.int64
    for i in range(vols.shape[0]):
        fc_i, steps_i = tn.drain(plan, vols[i])
        assert np.array_equal(fc_b[i], fc_i)
        assert steps_b[i] == steps_i
        fc_j, steps_j = jax_backend.drain(jplan, vols[i])
        np.testing.assert_allclose(fc_i, fc_j, rtol=1e-9, atol=1e-12)
        assert steps_i == steps_j


@needs_jax
def test_drain_batch_matches_numpy_at_a_bench_like_shape():
    """benchmarks/bench_backend.py's case cut down: a pairing job's lanes
    on a larger torus, integer volumes 1-2, against the public NumPy path
    per lane."""
    src, dst, _ = rn.bisection_pairing((4, 4, 2))
    paths = tn.dor_paths((8, 8, 8), src, dst, np.ones(src.shape[0]))
    jpaths = rn.dor_paths((8, 8, 8), src, dst, np.ones(src.shape[0]))
    vols = np.random.default_rng(11).integers(1, 3, size=(6, paths.n_flows)).astype(np.float64)
    fc, steps = tn.drain_batch(tn.prepare_drain(paths, device=CPU), vols)
    for i in range(vols.shape[0]):
        ref = rn.simulate_flows(dataclasses.replace(jpaths, vol=vols[i]))
        assert abs(float(fc[i].max()) - ref.makespan) <= 1e-9 * ref.makespan
        np.testing.assert_allclose(fc[i], ref.flow_completion, rtol=1e-9, atol=1e-12)
        assert steps[i] == ref.steps


def test_drain_edge_cases():
    paths = tn.dor_paths((4, 4), *tn.bisection_pairing((4, 4)))
    plan = tn.prepare_drain(paths, device=CPU)
    fc, steps = tn.drain(plan, np.zeros(plan.n_flows))  # nothing to drain
    assert steps == 0 and not fc.any()
    fc_b, steps_b = tn.drain_batch(plan, np.zeros((0, plan.n_flows)))
    assert fc_b.shape == (0, plan.n_flows) and steps_b.shape == (0,)
    empty = tn.dor_paths((4, 4), np.zeros((0, 2)), np.zeros((0, 2)), np.zeros(0))
    res = tn.simulate_flows(empty, device=CPU)
    assert res.makespan == 0.0 and res.steps == 0 and res.slowdown == 1.0
    src, dst, vol = _random_messages(2, (4, 4), 12)
    with pytest.raises(RuntimeError, match="exceeded 1 steps"):
        tn.simulate_flows(tn.dor_paths((4, 4), src, dst, vol), max_steps=1, device=CPU)


def test_drain_input_validation():
    paths = tn.dor_paths((4, 4), *tn.bisection_pairing((4, 4)))
    with pytest.raises(ValueError, match="link_bw"):
        tn.prepare_drain(paths, link_bw=0.0, device=CPU)
    with pytest.raises(ValueError, match="link_bw"):
        tn.simulate_flows(paths, link_bw=-1.0, device=CPU)
    plan = tn.prepare_drain(paths, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        tn.drain(plan, np.ones(plan.n_flows + 1))
    with pytest.raises(ValueError, match="shape"):
        tn.drain_batch(plan, np.ones((2, plan.n_flows + 1)))
    with pytest.raises(ValueError, match="shape"):
        tn.drain_batch(plan, np.ones(plan.n_flows))
    # The utilization timeline is recorded in the port's drain, as the
    # NumPy engine records it (the xla backend refuses it).
    res = tn.simulate_flows(paths, record_utilization=True, device=CPU)
    ref = rn.simulate_flows(rn.dor_paths((4, 4), *rn.bisection_pairing((4, 4))), record_utilization=True)
    assert [(u.start, u.end, u.max_utilization, u.mean_utilization, u.active_flows) for u in res.timeline] == \
        [(u.start, u.end, u.max_utilization, u.mean_utilization, u.active_flows) for u in ref.timeline]
    assert all(np.array_equal(a.utilization, b.utilization) for a, b in zip(res.timeline, ref.timeline))


def test_simulate_traffic_modes():
    traffic = tn.bisection_pairing((4, 4))
    res = tn.simulate_traffic((4, 4), traffic, device=CPU)
    ref = rn.simulate_traffic((4, 4), rn.bisection_pairing((4, 4)))
    _assert_drains_match(res, ref)
    adaptive = tn.simulate_traffic((4, 4), traffic, mode="adaptive", device=CPU)
    _assert_drains_match(adaptive, rn.simulate_traffic((4, 4), rn.bisection_pairing((4, 4)), mode="adaptive"))
    assert adaptive.mode == "adaptive"
    with pytest.raises(ValueError, match="unknown routing mode"):
        tn.simulate_traffic((4, 4), traffic, mode="valiant", device=CPU)


@needs_jax
@pytest.mark.parametrize("mode", ["minimal", "dal"])
def test_hyperx_paths_drain_through_interop(mode):
    """HyperX paths built by the JAX package, with their dense slot
    capacities, drain through the port as through the JAX engines."""
    fabric = HyperXFabric((4, 3), link_multiplicity=(1, 2))
    traffic = rn.random_permutation(fabric.dims, seed=5) if mode == "minimal" else rn.hotspot_line((4, 3))
    jpaths = rn.fabric_paths(fabric, traffic, mode=mode)
    paths = flow_paths_from_numpy(jpaths)
    assert paths.capacities is not None and paths.mode == mode
    res = tn.simulate_flows(paths, device=CPU)
    for ref in (rn.simulate_flows(jpaths), rn.simulate_flows(jpaths, backend="xla")):
        assert np.array_equal(res.link_loads, ref.link_loads)
        _assert_drains_match(res, ref)
    assert paths.max_link_load() == jpaths.max_link_load()


def test_flow_paths_from_numpy_round_trip():
    jpaths = rn.dor_paths((4, 3, 2), *rn.bisection_pairing((4, 3, 2)))
    paths = flow_paths_from_numpy(jpaths)
    assert isinstance(paths, tn.FlowPaths) and paths.capacities is None
    for f in dataclasses.fields(jpaths):
        a, b = getattr(paths, f.name), getattr(jpaths, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, f.name
    assert np.array_equal(paths.link_loads(), jpaths.link_loads())


# ---------------------------------------------------------------------------
# Batched candidate scoring.
# ---------------------------------------------------------------------------
@needs_jax
@settings(max_examples=6, deadline=None)
@given(
    dims=st.lists(st.integers(2, 4), min_size=2, max_size=3).map(tuple),
    seed=st.integers(0, 2**31 - 1),
    batch=st.integers(1, 6),
)
def test_score_candidates_rows_match_sequential(dims, seed, batch):
    rng = np.random.default_rng(seed)
    n_cells = int(np.prod(dims))
    n_ranks = min(6, n_cells)
    traffic = jax_pattern_traffic((n_ranks,), "ring")
    cells = np.stack([rng.choice(n_cells, n_ranks, replace=False) for _ in range(batch)])
    coords = np.stack(np.unravel_index(cells, dims), axis=-1).astype(np.int64)
    cong, dil = tn.score_candidates(dims, coords, traffic, device=CPU)
    cong_x, dil_x = jax_backend.score_candidates(dims, coords, traffic, backend="xla")
    assert np.array_equal(cong, cong_x) and np.array_equal(dil, dil_x)
    for i in range(batch):
        ref = jax_score_mapping(dims, coords[i], traffic)
        assert cong[i] == ref.congestion
        assert dil[i] == ref.dilation


@needs_jax
def test_score_candidates_edge_shapes():
    traffic = jax_pattern_traffic((4,), "ring")
    coords = np.stack(np.unravel_index(np.arange(4), (2, 2)), axis=-1)
    cong2d, dil2d = tn.score_candidates((2, 2), coords, traffic, device=CPU)
    assert cong2d.shape == (1,) and dil2d.shape == (1,)
    ref = jax_backend.score_candidates((2, 2), coords, traffic, backend="xla")
    assert cong2d[0] == ref[0][0] and dil2d[0] == ref[1][0]
    empty = np.zeros(0, dtype=np.int64)
    cong0, dil0 = tn.score_candidates((2, 2), coords, (empty, empty.copy(), np.zeros(0)), device=CPU)
    assert cong0.shape == (1,) and cong0[0] == 0.0 and dil0[0] == 0.0
    cong_b0, _ = tn.score_candidates((2, 2), np.zeros((0, 4, 2), dtype=np.int64), traffic, device=CPU)
    assert cong_b0.shape == (0,)
    with pytest.raises(ValueError, match="coords"):
        tn.score_candidates((2, 2), np.zeros((3,), dtype=np.int64), traffic, device=CPU)


@pytest.mark.parametrize("pattern", ["halo", "pairing", "ring", "all-to-all"])
@pytest.mark.parametrize("split_ties, double", [(True, True), (False, False)])
def test_score_mapping_matches_jax(pattern, split_ties, double):
    dims = (4, 4, 2)
    traffic = tn.pattern_traffic((4, 2, 2), pattern)
    coords = np.stack(np.unravel_index(np.random.default_rng(4).permutation(32)[:16], dims), axis=-1)
    got = tn.score_mapping(dims, coords, traffic, split_ties, double, device=CPU)
    want = jax_score_mapping(dims, coords, traffic, split_ties, double)
    assert (got.congestion, got.dilation) == (want.congestion, want.dilation)
    assert got.key() == want.key()


@pytest.mark.parametrize("pattern", ["halo", "pairing", "ring", "all-to-all"])
@pytest.mark.parametrize("logical", [(4, 3), (2, 2, 2), (1,)])
def test_pattern_traffic_matches_jax(pattern, logical):
    for a, b in zip(tn.pattern_traffic(logical, pattern, 1.5), jax_pattern_traffic(logical, pattern, 1.5)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown mapping pattern"):
        port_mapping.pattern_traffic(logical, "scatter")


@pytest.mark.parametrize(
    "name, args",
    [
        ("vertices", ((3, 2, 2),)),
        ("uniform_shift", ((4, 3), (1, 2), 2.0)),
        ("ring_shift", ((4, 3), 1, -1)),
        ("pairing_pairs", ((4, 3, 2),)),
        ("bisection_pairing", ((5, 4, 2),)),
        ("all_to_all", ((3, 2), 0.5, True)),
        ("nearest_neighbor_halo", ((4, 2, 1),)),
        ("nearest_neighbor_halo", ((1, 1),)),
        ("random_permutation", ((4, 4), 1.0, 9)),
        ("transpose", ((3, 3, 2),)),
        ("ring_all_reduce_phases", ((4, 2), 0, 8.0)),
        ("hotspot_line", ((6, 3),)),
        ("ring_all_gather", ((4, 2), 1, 8.0)),
    ],
)
def test_patterns_match_jax(name, args):
    got = getattr(port_patterns, name)(*args)
    want = getattr(rn.patterns, name)(*args)

    def flat(x):
        return [np.asarray(y) for part in x for y in (part if isinstance(part, tuple) else (part,))]

    got, want = (flat(x) if isinstance(x, list) else [np.asarray(y) for y in x] for x in (got, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The contention field.
# ---------------------------------------------------------------------------
def _grid(dims, boxes):
    grid = np.zeros(dims, dtype=bool)
    for lo, hi in boxes:
        grid[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
    return grid


CONTENTION_CASES = [  # (machine, occupied boxes, geometry, background from a placed job)
    ((8, 6, 4), [((0, 0, 0), (3, 2, 4)), ((5, 3, 1), (7, 5, 3))], (3, 2, 2), None),
    ((8, 8), [((0, 0), (4, 2))], (5, 2), ((4, 2), (0, 0))),
    ((7, 4, 2), [((2, 1, 0), (4, 3, 2))], (4, 2, 1), ((2, 2, 2), (2, 1, 0))),
    ((6, 6, 6), [], (3, 3, 2), ((5, 2, 1), (0, 0, 0))),
]


@needs_jax
@pytest.mark.parametrize("dims, boxes, geometry, background", CONTENTION_CASES)
def test_contention_field_matches_numpy_and_xla(dims, boxes, geometry, background):
    grid = _grid(dims, boxes)
    bg = None if background is None else jax_placement.placement_loads(dims, *background)
    mask = tn.interference_mask(grid, bg)
    assert np.array_equal(mask, jax_placement.interference_mask(grid, bg))
    for oriented in tn.orientations(geometry, dims):
        got = tn.contention_field(dims, oriented, mask, device=CPU)
        free = jax_placement.free_offset_mask(grid, oriented)
        for want in (
            jax_placement.contention_field(dims, oriented, mask),
            jax_placement.contention_field(dims, oriented, mask, backend="xla"),
        ):
            assert got.shape == dims
            assert np.abs(got - want).max() <= 1e-9 * max(1.0, float(np.abs(want).max()))
            if free.any():
                flat = np.flatnonzero(free.ravel())
                assert flat[np.argmin(np.round(got.ravel()[flat], 9))] == flat[
                    np.argmin(np.round(want.ravel()[flat], 9))
                ]


@pytest.mark.parametrize(
    "geometry, dims",
    [((4, 2), (4, 4)), ((2, 2, 2), (4, 2, 2)), ((3, 2), (2, 5, 3)), ((8,), (4, 4)), ((2, 1, 1, 1), (3, 3))],
)
def test_placement_helpers_match_jax(geometry, dims):
    assert tn.orientations(geometry, dims) == jax_placement.orientations(geometry, dims)
    for oriented in tn.orientations(geometry, dims):
        for a, b in zip(
            tn.placement_all_to_all_traffic(dims, oriented, (1,) * len(dims)),
            jax_placement.placement_all_to_all_traffic(dims, oriented, (1,) * len(dims)),
        ):
            assert np.array_equal(a, b)
        assert np.array_equal(tn.base_loads(dims, oriented, device=CPU), jax_placement.base_loads(dims, oriented))


def test_placement_helpers_reject_what_jax_rejects():
    with pytest.raises(ValueError, match="non-trivial dims"):
        port_placement.pad_geometry((2, 2, 2), 2)
    with pytest.raises(ValueError, match="shapes differ"):
        tn.contention_field((4, 4), (2, 2), np.zeros((2, 2, 4, 3), dtype=bool), device=CPU)


# ---------------------------------------------------------------------------
# Cut tables.
# ---------------------------------------------------------------------------
@needs_jax
@settings(max_examples=10, deadline=None)
@given(dims=dims_strategy, t=st.integers(1, 32))
def test_cut_table_parity(dims, t):
    got = tn.cut_table(dims, t, device=CPU)
    for want in (rn.cut_table(dims, t), rn.cut_table(dims, t, backend="xla")):
        assert got.items() == want.items()
        assert got.dims == want.dims and got.t == want.t
    assert got.cuts.dtype == np.int64 and got.geometries.dtype == np.int64


@pytest.mark.parametrize("machine", ["Mira", "JUQUEEN", "Sequoia"])
def test_cut_table_on_the_bgq_midplane_tori(machine):
    torus = bgq.MACHINES[machine].midplane_dims
    for mp in bgq.MIRA_SCHEDULER_PARTITIONS:
        got, want = tn.cut_table(torus, mp, device=CPU), rn.cut_table(torus, mp)
        assert got.items() == want.items()
        if len(want):
            assert got.min_cut_geometry() == want.min_cut_geometry()
            assert got.max_cut_geometry() == want.max_cut_geometry()


def test_cut_table_fabrics_and_errors():
    fabric = TorusFabric.bgq((4, 4, 2))
    assert tn.cut_table(fabric, 8, device=CPU).items() == rn.cut_table(fabric, 8).items()
    assert tn.cut_table(tn.HyperXFabric((4, 4), link_bw=1.0), 4, device=CPU).items() == \
        rn.cut_table(HyperXFabric((4, 4)), 4).items() == [((2, 2), 16), ((4, 1), 12)]
    with pytest.raises(TypeError, match="repro_torch HyperXFabric"):
        tn.cut_table(HyperXFabric((4, 4)), 4, device=CPU)
    with pytest.raises(ValueError, match="t must be"):
        tn.cut_table((4, 4), 0, device=CPU)
    assert len(tn.cut_table((2, 2), 5, device=CPU)) == 0
    assert tn.cut_scores((4, 4), np.zeros((0, 2), dtype=np.int64), 4, device=CPU).shape == (0,)


# ---------------------------------------------------------------------------
# Golden partition pairs, the paper's tables, and the device rule.
# ---------------------------------------------------------------------------
@needs_jax
@pytest.mark.parametrize("dims", [(16, 4, 4, 4, 2), (8, 8, 4, 4, 2)], ids=["mira-4mp", "juqueen-4mp"])
def test_golden_partition_parity(dims):
    src, dst, vol = rn.bisection_pairing(dims)
    loads = tn.route_dor(dims, src, dst, vol, device=CPU)
    assert np.array_equal(loads, rn.route_dor(dims, src, dst, vol))
    assert np.array_equal(loads, rn.route_dor(dims, src, dst, vol, backend="xla"))
    res = tn.simulate_traffic(dims, (src, dst, vol), device=CPU)
    ref = rn.simulate_traffic(dims, (src, dst, vol))
    assert abs(res.makespan - ref.makespan) <= 1e-9 * ref.makespan
    assert res.steps == ref.steps == 1


def test_chip_smoke_network_tables_match_the_paper():
    """chip_smoke.py's phase 6 carries the paper's tables as literals (it
    imports nothing of repro): they must be repro.core.bgq's, and its
    Table 1 ratios and whole-machine makespans the closed forms'."""
    assert chip_smoke.MIRA_SCHEDULER_PARTITIONS == bgq.MIRA_SCHEDULER_PARTITIONS
    assert chip_smoke.MIRA_PROPOSED_PARTITIONS == bgq.MIRA_PROPOSED_PARTITIONS
    for name, dims in chip_smoke.MIDPLANE_TORI.items():
        assert dims == bgq.MACHINES[name].midplane_dims
        assert chip_smoke.node_dims(dims) == bgq.MACHINES[name].node_dims
    for mp, proposed in chip_smoke.MIRA_PROPOSED_PARTITIONS.items():
        ratio = jax_routing.pairing_speedup(
            bgq.node_dims_of_midplane_geometry(bgq.MIRA_SCHEDULER_PARTITIONS[mp]),
            bgq.node_dims_of_midplane_geometry(proposed),
        )
        assert ratio == pytest.approx(chip_smoke.TABLE1_RATIOS[mp], rel=1e-12)
    for name, makespan in chip_smoke.FULL_MACHINE_PAIRING.items():
        dims = bgq.MACHINES[name].node_dims
        assert rn.uniform_offset_max_load(dims, rn.furthest_offset(dims)) == makespan


def test_chip_smoke_allocation_cases_match_the_repo():
    """chip_smoke.py's phase 7 carries its cases as literals: a BG/Q
    midplane, BENCH_scheduler.json's largest scenario (with the bench's
    own stream), sizes from Mira's scheduler table, the paper's Table 1
    speedups from the JAX advisor, and Mira's node torus for the mapping."""
    import inspect
    import json

    from benchmarks import bench_scheduler

    assert chip_smoke.MIDPLANE_NODES == bgq.MIDPLANE_DIMS
    sc = chip_smoke.SCHEDULER_SCENARIO
    rows = json.loads((Path(__file__).resolve().parents[1] / "BENCH_scheduler.json").read_text())["rows"]
    largest = max((r for r in rows if "scenario_jobs" in r), key=lambda r: r["grid"][0])
    assert list(sc["machine"]) == largest["grid"] and sc["jobs"] == largest["scenario_jobs"]
    source = inspect.getsource(bench_scheduler)
    assert f"_service_throughput({sc['machine']}, {sc['jobs']}, seed={sc['seed']})" in source
    for key in ("burst_gap", "mean_duration", "failure_rate", "repair_delay"):
        assert f"{key}={sc[key]}," in source
    assert set(chip_smoke.QUEUE_SIZES) <= set(bgq.MIRA_SCHEDULER_PARTITIONS)
    for mp, ratio in chip_smoke.TABLE1_RATIOS.items():
        advice = rn.advise_partition(bgq.MIRA.midplane_dims, mp, bgq.MIRA_SCHEDULER_PARTITIONS[mp],
                                     unit_node_dims=bgq.MIDPLANE_DIMS)
        assert advice.predicted_speedup == ratio
        assert advice.optimal_geometry == bgq.MIRA_PROPOSED_PARTITIONS[mp]
    machine, job = chip_smoke.MAP_JOB
    assert machine == bgq.MIRA.node_dims and job == bgq.node_dims_of_midplane_geometry((2, 2, 2, 2))
    assert chip_smoke.ADVISOR_SIMULATE_NODES == 16 * bgq.MIDPLANE_NODES


ENTRY_POINTS = {
    "route_dor": lambda: tn.route_dor((4, 4), [[0, 0]], [[2, 1]], 1.0),
    "route_dor_empty": lambda: tn.route_dor((4, 4), np.zeros((0, 2)), np.zeros((0, 2)), 1.0),
    "prepare_drain": lambda: tn.prepare_drain(tn.dor_paths((4, 4), *tn.bisection_pairing((4, 4)))),
    "simulate_flows": lambda: tn.simulate_flows(tn.dor_paths((4, 4), *tn.bisection_pairing((4, 4)))),
    "simulate_traffic": lambda: tn.simulate_traffic((4, 4), tn.bisection_pairing((4, 4))),
    "score_candidates": lambda: tn.score_candidates((2, 2), [[[0, 0], [1, 1]]], ([0], [1], [1.0])),
    "score_mapping": lambda: tn.score_mapping((2, 2), [[0, 0], [1, 1]], ([0], [1], [1.0])),
    "base_loads": lambda: tn.base_loads((4, 4), (2, 2)),
    "contention_field": lambda: tn.contention_field((4, 4), (2, 2), np.zeros((2, 2, 4, 4), dtype=bool)),
    "cut_table": lambda: tn.cut_table((4, 4), 4),
    "cut_scores": lambda: tn.cut_scores((4, 4), [[2, 2]], 4),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(monkeypatch, name):
    """Every entry point runs on the card by default and never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[name]()


def test_dispatches_are_counted_by_pass_and_device():
    before = DISPATCHES.copy()
    paths = tn.dor_paths((4, 4), *tn.bisection_pairing((4, 4)))
    tn.simulate_flows(paths, device=CPU)
    tn.drain_batch(tn.prepare_drain(paths, device=CPU), np.ones((3, paths.n_flows)))
    tn.route_dor((4, 4), [[0, 0]], [[2, 1]], 1.0, device=CPU)
    tn.cut_table((4, 4), 4, device=CPU)
    delta = DISPATCHES - before
    assert delta == {("drain", "cpu"): 1, ("drain_batch", "cpu"): 1, ("route_loads", "cpu"): 1, ("cut_scores", "cpu"): 1}
