"""Parity of the port's placement engine and allocator (``repro_torch.
network.placement`` / ``allocation``) with the JAX package, on the CPU.

Placements, first fits and windowed sums are exact; the machine state's
background fields are bit-identical; ``simulate_queue`` gives the same
schedules under the five policies and both contention models, with
``predicted_contention`` equal after rounding to 9 decimals and
``simulated_comm_time`` within ``rtol=1e-9, atol=1e-12``.  Tori: (4, 4, 4),
(6, 4, 2), Mira's (4, 4, 3, 2) and JUQUEEN's (7, 2, 2, 2) midplanes.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.core import bgq  # noqa: E402
from repro.network import placement as jax_placement  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch.network import backend as port_backend  # noqa: E402
from repro_torch.network import placement as port_placement  # noqa: E402
from repro_torch.obs import DISPATCHES  # noqa: E402

CPU = "cpu"
MIRA, JUQUEEN = bgq.MIRA.midplane_dims, bgq.JUQUEEN.midplane_dims
UNIT = bgq.MIDPLANE_DIMS


def _random_case(seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(x) for x in rng.integers(2, 8, int(rng.integers(1, 4))))
    grid = rng.random(dims) < rng.random() * 0.6
    geometry = tuple(int(rng.integers(1, a + 1)) for a in dims)
    background = None
    if rng.random() < 0.5:
        oriented = tuple(int(rng.integers(1, a + 1)) for a in dims)
        offset = tuple(int(rng.integers(0, a)) for a in dims)
        background = jax_placement.placement_loads(dims, oriented, offset)
    return dims, grid, geometry, background


def _fields(p):
    return None if p is None else dataclasses.astuple(p)


@pytest.mark.parametrize("seed", range(12))
def test_best_placement_and_first_fit_match_jax(seed):
    for s in range(seed * 10, seed * 10 + 10):
        dims, grid, geometry, background = _random_case(s)
        got = port_placement.best_placement(grid, geometry, background, device=CPU)
        assert _fields(got) == _fields(jax_placement.best_placement(grid, geometry, background))
        assert port_placement.first_fit(grid, geometry, device=CPU) == jax_placement.first_fit(grid, geometry)
        for perm in port_placement.orientations(geometry, dims):
            assert np.array_equal(port_placement.free_offset_mask(grid, perm, device=CPU),
                                  jax_placement.free_offset_mask(grid, perm))
            assert np.array_equal(port_placement.shell_contact(grid, perm, device=CPU),
                                  jax_placement.shell_contact(grid, perm))


@pytest.mark.parametrize("dims, geometry", [((8, 6, 4), (3, 2, 2)), ((7, 2, 2, 2), (4, 2, 1, 1)), ((4, 4, 3, 2), (2, 2, 2, 1))])
def test_best_placement_matches_the_xla_backend(dims, geometry):
    rng = np.random.default_rng(7)
    grid = rng.random(dims) < 0.3
    background = jax_placement.placement_loads(dims, tuple(min(2, a) for a in dims), (1,) * len(dims))
    want = jax_placement.best_placement(grid, geometry, background, backend="xla")
    assert _fields(port_placement.best_placement(grid, geometry, background, device=CPU)) == _fields(want)


def test_placement_helpers_match_jax():
    dims = (6, 4, 2)
    grid = np.zeros(dims, dtype=bool)
    grid[:2, :2] = True
    for oriented, offset in [((3, 2, 2), (5, 3, 1)), ((2, 4, 1), (0, 1, 0)), ((1, 1, 1), (2, 2, 0))]:
        assert np.array_equal(port_placement.int_base_loads(dims, oriented, device=CPU),
                              jax_placement.int_base_loads(dims, oriented))
        assert np.array_equal(port_placement.int_placement_loads(dims, oriented, offset, device=CPU),
                              jax_placement.int_placement_loads(dims, oriented, offset))
        for pattern in ("all-to-all", "pairing"):
            got = port_placement.placement_loads(dims, oriented, offset, pattern, device=CPU)
            assert np.array_equal(got, jax_placement.placement_loads(dims, oriented, offset, pattern))
        for a, b in zip(port_placement.placement_pairing_traffic(dims, oriented, offset),
                        jax_placement.placement_pairing_traffic(dims, oriented, offset)):
            assert np.array_equal(a, b)
        for a, b in zip(port_placement.placement_cells(dims, oriented, offset),
                        jax_placement.placement_cells(dims, oriented, offset)):
            assert np.array_equal(a, b)
        assert port_placement.is_spilling(oriented, dims) == jax_placement.is_spilling(oriented, dims)
        bg = jax_placement.placement_loads(dims, oriented, offset)
        assert port_placement.shared_link_contention(bg, grid[None, None] * 1.0 + 0 * bg) == \
            jax_placement.shared_link_contention(bg, grid[None, None] * 1.0 + 0 * bg)
    got = [(p, m.tolist()) for p, m in port_placement.iter_free_placements(grid, (2, 2, 1), device=CPU)]
    assert got == [(p, m.tolist()) for p, m in jax_placement.iter_free_placements(grid, (2, 2, 1))]
    for dims in (MIRA, JUQUEEN, (6, 4, 2), (5, 5)):
        assert port_placement.fabric_can_interfere(dims) == jax_placement.fabric_can_interfere(dims)
    with pytest.raises(ValueError, match="window"):
        port_placement._circular_window_sums(grid, (7, 1, 1), device=CPU)
    with pytest.raises(ValueError, match="unknown traffic pattern"):
        port_placement.placement_loads(dims, (1, 1, 1), (0, 0, 0), "ring", device=CPU)


def test_int_fields_are_cached_per_device_and_never_written():
    dims, oriented = (6, 4, 2), (3, 2, 2)
    field = port_placement.int_base_loads(dims, oriented, device=CPU)
    assert not field.flags.writeable
    machine = tn.MachineState(dims, device=CPU)
    machine.commit(0, (3, 2, 2), oriented, (0, 0, 0))  # at the origin: the cached field itself
    machine.commit(1, (3, 2, 2), oriented, (3, 0, 0))
    machine.release(0)
    assert np.array_equal(port_placement.int_base_loads(dims, oriented, device=CPU), field)


def test_snapped_contention_on_a_512_cell_geometry():
    """A 512-cell job: the search ranks the exact field (a sum of integers
    over the mask), which the raw FFT value only approximates.  At n = 512
    the exact values are multiples of 1/512 (ties come in reversed pairs,
    so the integer field is even); a raw value 1e-12 off a 9-decimal tie
    such as 1/1024 rounds by its noise, the snapped one cannot."""
    dims, oriented = (12, 8, 8), (8, 8, 8)
    n = 512
    rng = np.random.default_rng(5)
    grid = np.zeros(dims, dtype=bool)
    grid[8:] = rng.random((4, 8, 8)) < 0.3
    background = (rng.random((3, 2) + dims) < 0.05).astype(np.float64)
    mask = jax_placement.interference_mask(grid, background)
    J = jax_placement.int_base_loads(dims, oriented)
    exact = np.zeros(dims, dtype=np.int64)
    for o in itertools.product(*(range(a) for a in dims)):
        exact[o] = int((np.roll(J, o, axis=(2, 3, 4)) * mask).sum())
    m = torch.from_numpy(mask)
    snapped, gap = port_backend.snapped_contention(port_backend.mask_fft(m), torch.from_numpy(np.array(J)))
    assert np.array_equal(snapped.numpy(), exact.astype(np.float64)) and 0 < float(gap) < 1e-6
    assert not (J % 2).any() and not (exact % 2).any()
    raw = jax_placement.contention_field(dims, oriented, mask)
    assert np.abs(raw - exact / (2 * n)).max() > 0.0  # the JAX package ranks these
    got = port_placement.best_placement(grid, oriented, background, device=CPU)
    free = np.flatnonzero(jax_placement.free_offset_mask(grid, oriented))
    key = np.round(exact.ravel()[free] / (2 * n), 9)
    best = free[np.lexsort((free, key))[0]]
    assert got.offset == tuple(int(x) for x in np.unravel_index(best, dims))
    assert got.contention == round(exact.ravel()[best] / (2 * n), 9)
    # The boundary the snap removes: 1/1024 rounds half-to-even, 1e-12 either
    # side of it rounds by the noise.
    at = torch.tensor([1.0, 1.0 + 2e-9, 1.0 - 2e-9], dtype=torch.float64) / 1024.0
    assert torch.round(at, decimals=9).tolist() == [0.000976562, 0.000976563, 0.000976562]
    assert round(1 / 1024, 9) == 0.000976562


# ---------------------------------------------------------------------------
# The machine state.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dims", [(4, 4, 4), (6, 4, 2)])
def test_machine_state_stream_is_bit_identical_to_jax(seed, dims):
    rng = np.random.default_rng(seed)
    geoms = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (4, 2, 1), (3, 2, 1)]
    want, got = rn.MachineState(dims), tn.MachineState(dims, device=CPU)
    live = []
    for step in range(80):
        if live and rng.random() < 0.45:
            k = live.pop(int(rng.integers(len(live))))
            want.release(k)
            got.release(k)
        else:
            g = geoms[int(rng.integers(len(geoms)))]
            scored = rng.random() < 0.5
            p = (want.allocate_scored if scored else want.allocate)(step, g)
            q = (got.allocate_scored if scored else got.allocate)(step, g)
            assert _fields(q) == _fields(p)
            if p is not None:
                live.append(step)
        assert np.array_equal(got.grid.numpy(), want.grid) and got.free_units == want.free_units
        assert np.array_equal(got.traffic_loads(), want.traffic_loads())
        if live:
            jid = live[int(rng.integers(len(live)))]
            assert np.array_equal(got.traffic_loads(exclude=jid), want.traffic_loads(exclude=jid))
    fresh = tn.MachineState(dims, device=CPU)
    for jid in live:
        p = got.placements[jid]
        fresh.commit(jid, p.geometry, p.oriented, p.offset)
    assert np.array_equal(fresh.traffic_loads(), got.traffic_loads())


def test_machine_state_commit_validation_and_fabric():
    machine = tn.MachineState(tn.TorusFabric.bgq(MIRA, link_bw=1.0), device=CPU)
    assert machine.dims == MIRA and machine.fabric_or_dims.dims == MIRA
    machine.commit(0, (2, 2, 1, 1), (2, 1, 2, 1), (3, 3, 2, 1))
    with pytest.raises(ValueError, match="already placed"):
        machine.commit(0, (2, 2, 1, 1), (2, 1, 2, 1), (0, 0, 0, 0))
    with pytest.raises(ValueError, match="overlaps"):
        machine.commit(1, (2, 2, 1, 1), (2, 2, 1, 1), (3, 3, 2, 1))
    with pytest.raises(ValueError, match="arrangement"):
        machine.commit(1, (2, 2, 1, 1), (4, 1, 1, 1), (0, 0, 0, 0))
    with pytest.raises(ValueError, match="does not fit"):
        machine.commit(1, (2, 2, 1, 1), (1, 1, 4, 1), (0, 0, 0, 0))
    assert machine.find_placement((4, 4, 3, 2)) is None
    assert machine.placements[0].bisection_links == rn.MachineState(MIRA).commit(
        0, (2, 2, 1, 1), (2, 1, 2, 1), (3, 3, 2, 1)).bisection_links


# ---------------------------------------------------------------------------
# Policies and the queue simulator.
# ---------------------------------------------------------------------------
def _jobs(package, seed, n, sizes):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(2.0))
        out.append(package.JobRequest(i, int(rng.choice(sizes)), duration=float(rng.uniform(1, 10)),
                                      arrival=t, contention_bound=bool(rng.random() < 0.7)))
    return out


def _policy(package, name):
    return {
        "list": lambda: package.ListPolicy(bgq.MIRA_SCHEDULER_PARTITIONS),
        "isoperimetric": package.IsoperimetricPolicy,
        "contention-scored": package.ContentionScoredPolicy,
        "elongated": package.ElongatedPolicy,
        "hinted": package.HintedPolicy,
    }[name]()


def _assert_same_schedule(got, want):
    assert got.policy == want.policy and got.rejected == want.rejected
    assert len(got.jobs) == len(want.jobs)
    for g, w in zip(got.jobs, want.jobs):
        assert dataclasses.astuple(g.request) == dataclasses.astuple(w.request)
        gp, wp = g.placement, w.placement
        assert (gp.job_id, gp.geometry, gp.oriented, gp.offset, gp.bisection_links) == \
            (wp.job_id, wp.geometry, wp.oriented, wp.offset, wp.bisection_links)
        assert round(gp.predicted_contention, 9) == round(wp.predicted_contention, 9)
        assert (g.start, g.end, g.predicted_comm_time, g.bisection_efficiency) == \
            (w.start, w.end, w.predicted_comm_time, w.bisection_efficiency)
        np.testing.assert_allclose(g.comm_lower_bound, w.comm_lower_bound, rtol=1e-9, atol=1e-12)
        if w.simulated_comm_time is None:
            assert g.simulated_comm_time is None
        else:
            np.testing.assert_allclose(g.simulated_comm_time, w.simulated_comm_time, rtol=1e-9, atol=1e-12)
        assert (g.mapping is None) == (w.mapping is None)
        if w.mapping is not None:
            assert g.mapping.strategy == w.mapping.strategy
            assert np.array_equal(g.mapping.coords, w.mapping.coords)
    for prop in ("mean_comm_time", "makespan", "mean_wait", "mean_bisection_efficiency"):
        assert getattr(got, prop) == getattr(want, prop)
    np.testing.assert_allclose(got.mean_simulated_slowdown, want.mean_simulated_slowdown, rtol=1e-9)
    np.testing.assert_allclose(got.mean_contention, want.mean_contention, rtol=1e-9, atol=1e-9)


QUEUE_CASES = [  # (machine, unit node dims, job sizes, policies)
    (MIRA, UNIT, [1, 2, 4, 8, 16, 24], ["list", "isoperimetric", "contention-scored", "elongated", "hinted"]),
    (JUQUEEN, UNIT, [1, 2, 4, 7, 8, 14], ["isoperimetric", "contention-scored", "elongated", "hinted"]),
    ((6, 4, 2), None, [1, 2, 4, 6, 8, 12], ["isoperimetric", "contention-scored", "elongated", "hinted"]),
]
MODES = [
    dict(),
    dict(contention="static"),
    dict(contention="simulated", backfill=True),
    dict(contention="simulated", mapping_pattern="halo"),
    dict(measure_contention=True, mapping_pattern="ring", backfill=True),
]


@pytest.mark.parametrize("dims, unit, sizes, names", QUEUE_CASES, ids=["mira", "juqueen", "6x4x2"])
@pytest.mark.parametrize("mode", range(len(MODES)))
def test_simulate_queue_matches_jax(dims, unit, sizes, names, mode):
    mapped = "mapping_pattern" in MODES[mode]
    for name in names[:2] if mapped else names:  # a mapping pass per job: two policies
        want = rn.simulate_queue(dims, _jobs(rn, 0, 12, sizes), _policy(rn, name), unit, **MODES[mode])
        got = tn.simulate_queue(dims, _jobs(tn, 0, 12, sizes), _policy(tn, name), unit, device=CPU, **MODES[mode])
        _assert_same_schedule(got, want)


def test_simulate_queue_matches_the_xla_backend_and_reports_slowdown():
    sizes = [1, 2, 4, 6, 8, 12]
    want = rn.simulate_queue((6, 4, 2), _jobs(rn, 0, 24, sizes), rn.ElongatedPolicy(), contention="simulated",
                             backend="xla")
    got = tn.simulate_queue((6, 4, 2), _jobs(tn, 0, 24, sizes), tn.ElongatedPolicy(), contention="simulated",
                            device=CPU)
    _assert_same_schedule(got, want)
    assert want.mean_simulated_slowdown > 1.0  # spans of 6 spill: jobs do contend


def test_simulate_queue_requested_geometry_and_errors():
    for package, kw in ((rn, {}), (tn, {"device": CPU})):
        with pytest.raises(ValueError, match="mapping_pattern requires"):
            package.simulate_queue((4, 4), [], package.IsoperimetricPolicy(), mapping_pattern="halo", **kw)
        with pytest.raises(ValueError, match="contention must be"):
            package.simulate_queue((4, 4), [], package.IsoperimetricPolicy(), contention="exact", **kw)
        with pytest.raises(ValueError, match="volume"):
            package.JobRequest(0, 8, geometry=(2, 2))
        with pytest.raises(ValueError, match="min_bisection_efficiency"):
            package.ContentionScoredPolicy(1.5)
    jobs = lambda p: [p.JobRequest(0, 8, geometry=(8, 1, 1)), p.JobRequest(1, 8), p.JobRequest(2, 3)]  # noqa: E731
    for policy in ("isoperimetric", "contention-scored", "hinted", "elongated"):
        want = rn.simulate_queue((8, 4, 2), jobs(rn), _policy(rn, policy))
        got = tn.simulate_queue((8, 4, 2), jobs(tn), _policy(tn, policy), device=CPU)
        _assert_same_schedule(got, want)
    floor_w = rn.ContentionScoredPolicy(min_bisection_efficiency=0.9)
    floor_g = tn.ContentionScoredPolicy(min_bisection_efficiency=0.9)
    assert floor_g.geometry_preferences(tn.MachineState(MIRA, device=CPU), 8) == \
        floor_w.geometry_preferences(rn.MachineState(MIRA), 8)


@pytest.mark.parametrize("machine", [MIRA, JUQUEEN])
def test_avoidable_contention_ratio_matches_jax(machine):
    for units in bgq.BlueGeneQ("m", machine).partition_sizes()[1:]:  # one unit has no traffic: 0 / 0
        for unit in (UNIT, None):
            assert tn.avoidable_contention_ratio(machine, units, unit, device=CPU) == \
                rn.avoidable_contention_ratio(machine, units, unit)
    with pytest.raises(ValueError, match="no cuboid"):
        tn.avoidable_contention_ratio((2, 2), 5, device=CPU)


def test_device_reaches_every_pass():
    """Where the JAX package's simulate_queue hands its backend to the
    drains only, the port's device reaches every pass: the cut tables
    behind the policies, the placement search, the mapping and the
    drains all run on the device asked for, and nothing else."""
    before = DISPATCHES.copy()
    tn.simulate_queue((6, 4, 2), _jobs(tn, 2, 8, [2, 4, 8]), tn.ContentionScoredPolicy(), contention="simulated",
                      mapping_pattern="halo", device=CPU)
    tn.simulate_queue((6, 4, 2), _jobs(tn, 3, 8, [2, 3, 4]), tn.IsoperimetricPolicy(), contention="simulated",
                      device=CPU)
    tn.advise_partition(MIRA, 4, unit_node_dims=UNIT, simulate=True, device=CPU)
    delta = DISPATCHES - before
    assert {dev for _, dev in delta} == {"cpu"}
    assert {name for name, _ in delta} >= {"cut_scores", "placement_search", "contention_field", "first_fit",
                                             "score_candidates", "route_loads", "drain"}


ENTRY_POINTS = {
    "MachineState": lambda: tn.MachineState((4, 4)),
    "simulate_queue": lambda: tn.simulate_queue((4, 4), [tn.JobRequest(0, 4)], tn.IsoperimetricPolicy()),
    "avoidable_contention_ratio": lambda: tn.avoidable_contention_ratio((4, 4), 4),
    "best_placement": lambda: tn.best_placement(np.zeros((4, 4), dtype=bool), (2, 2)),
    "first_fit": lambda: tn.first_fit(np.zeros((4, 4), dtype=bool), (2, 2)),
    "free_offset_mask": lambda: tn.free_offset_mask(np.zeros((4, 4), dtype=bool), (2, 2)),
    "shell_contact": lambda: tn.shell_contact(np.zeros((4, 4), dtype=bool), (2, 2)),
    "placement_loads": lambda: tn.placement_loads((4, 4), (2, 2), (0, 0)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[name]()
