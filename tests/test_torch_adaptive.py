"""Parity of the port's minimal-adaptive torus router, routing comparison
and utilization timeline (``repro_torch.network.netsim``,
``backend.adaptive_links`` and ``backend.drain_timeline``) with the JAX
package's NumPy engine, on the CPU.

    adaptive_paths          link and flow ids equal for integer volumes;
                            makespans within 1e-9 relative for float ones
    compare_routing         makespans within 1e-9 relative; pairing on the
                            paper's partitions recovers 0.0, a hotspot line
                            recovers more than 0
    record_utilization      steps and active counts equal, samples (times,
                            max, mean, per-link tensors) within 1e-9 relative
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.network import netsim as jax_netsim  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch.network import netsim as port_netsim  # noqa: E402
from repro_torch.obs import DISPATCHES  # noqa: E402

CPU = "cpu"
RTOL = 1e-9
DIMS = [(4, 4), (6, 4, 2), (8, 8), (5, 3, 4), (4, 4, 3, 2), (2, 2, 2), (7,), (3, 1, 6)]


def _messages(seed, dims, n, integer=True):
    rng = np.random.default_rng(seed)
    src = np.stack([rng.integers(0, a, n) for a in dims], axis=1)
    dst = np.stack([rng.integers(0, a, n) for a in dims], axis=1)
    vol = rng.integers(1, 6, n).astype(np.float64) if integer else rng.uniform(0.1, 3.0, n)
    return src, dst, vol


@pytest.mark.parametrize("dims", DIMS, ids=str)
@pytest.mark.parametrize("split_ties", [True, False])
def test_adaptive_paths_equal_jax_for_integer_volumes(dims, split_ties):
    src, dst, vol = _messages(sum(dims) + split_ties, dims, 60)
    want = jax_netsim.adaptive_paths(dims, src, dst, vol, split_ties=split_ties)
    got = port_netsim.adaptive_paths(dims, src, dst, vol, split_ties=split_ties, device=CPU)
    assert got.mode == want.mode == "adaptive"
    assert got.n_messages == want.n_messages
    for name in ("msg", "vol", "link_ids", "flow_ids"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(got.link_loads(), want.link_loads())


@pytest.mark.parametrize("dims", [(4, 4), (6, 4, 2), (5, 3, 4)], ids=str)
def test_adaptive_makespans_match_jax_for_float_volumes(dims):
    traffic = _messages(7, dims, 50, integer=False)
    want = rn.simulate_traffic(dims, traffic, mode="adaptive")
    got = tn.simulate_traffic(dims, traffic, mode="adaptive", device=CPU)
    np.testing.assert_allclose(got.makespan, want.makespan, rtol=RTOL)
    np.testing.assert_allclose(got.completion, want.completion, rtol=RTOL, atol=1e-12)


def test_adaptive_keeps_hop_volume_and_the_divert_margin():
    dims = (8, 8)
    src, dst, vol = rn.hotspot_line(dims)
    dor = tn.dor_paths(dims, src, dst, vol)
    never = port_netsim.adaptive_paths(dims, src, dst, vol, divert_margin=0.0, device=CPU)
    assert np.array_equal(np.sort(never.link_ids), np.sort(dor.link_ids))  # never diverts: DOR's links
    adp = port_netsim.adaptive_paths(dims, src, dst, vol, device=CPU)
    assert adp.link_loads().sum() == dor.link_loads().sum()
    want = jax_netsim.adaptive_paths(dims, src, dst, vol, divert_margin=0.9)
    got = port_netsim.adaptive_paths(dims, src, dst, vol, divert_margin=0.9, device=CPU)
    assert np.array_equal(got.link_ids, want.link_ids) and np.array_equal(got.flow_ids, want.flow_ids)
    empty = port_netsim.adaptive_paths(dims, np.zeros((0, 2), int), np.zeros((0, 2), int), 1.0, device=CPU)
    assert empty.n_flows == 0 and empty.link_ids.shape == (0,)


ROUTING_CASES = [(d, p) for d in [(4, 4, 2), (8, 4, 4, 2), (4, 4, 4, 4, 2), (6, 4, 2)]
                 for p in ("pairing", "hotspot_line")] + [((4, 4, 2), "permutation"), ((6, 4, 2), "permutation")]


@pytest.mark.parametrize("dims, pattern", ROUTING_CASES, ids=str)
def test_compare_routing_matches_jax(dims, pattern):
    traffic = {"pairing": rn.bisection_pairing, "hotspot_line": rn.hotspot_line,
               "permutation": lambda d: rn.random_permutation(d, seed=5)}[pattern](dims)
    want = rn.compare_routing(dims, traffic)
    got = tn.compare_routing(dims, traffic, device=CPU)
    assert got.dims == want.dims
    np.testing.assert_allclose([got.dor_makespan, got.adaptive_makespan],
                               [want.dor_makespan, want.adaptive_makespan], rtol=RTOL)
    np.testing.assert_allclose(got.recovered_fraction, want.recovered_fraction, rtol=RTOL, atol=1e-12)
    if pattern == "pairing":
        assert got.recovered_fraction == 0.0  # the paper's argument: routing recovers nothing
    if pattern == "hotspot_line":
        assert got.recovered_fraction > 0.0


def test_compare_routing_on_mira_partition_pairs():
    """The paper's current and proposed Mira geometries at node level, at
    reduced size (2 and 4 midplanes): pairing recovers nothing under
    either geometry."""
    for cur, prop in [((8, 4, 4, 4, 2), (4, 4, 4, 4, 4)), ((16, 4, 4, 4, 2), (8, 8, 4, 4, 2))]:
        for dims in (cur, prop):
            traffic = rn.bisection_pairing(dims)
            got = tn.compare_routing(dims, traffic, device=CPU)
            want = rn.compare_routing(dims, traffic)
            assert (got.dor_makespan, got.adaptive_makespan) == (want.dor_makespan, want.adaptive_makespan)
            assert got.recovered_fraction == 0.0


def test_build_paths_modes_and_dispatch_counts():
    traffic = rn.bisection_pairing((4, 4))
    before = DISPATCHES[("adaptive_links", "cpu")]
    for mode in ("dor", "adaptive"):
        got = port_netsim.build_paths((4, 4), traffic, mode=mode, device=CPU)
        want = jax_netsim.build_paths((4, 4), traffic, mode=mode)
        assert got.mode == want.mode and np.array_equal(got.link_ids, want.link_ids)
    assert DISPATCHES[("adaptive_links", "cpu")] == before + 1
    with pytest.raises(ValueError, match="unknown routing mode"):
        port_netsim.build_paths((4, 4), traffic, mode="valiant", device=CPU)


def _assert_timelines_match(got, want):
    assert got.steps == want.steps and len(got.timeline) == len(want.timeline) == want.steps
    for a, b in zip(got.timeline, want.timeline):
        assert a.active_flows == b.active_flows
        np.testing.assert_allclose([a.start, a.end, a.max_utilization, a.mean_utilization],
                                   [b.start, b.end, b.max_utilization, b.mean_utilization], rtol=RTOL, atol=1e-12)
        assert a.utilization.shape == b.utilization.shape
        np.testing.assert_allclose(a.utilization, b.utilization, rtol=RTOL, atol=1e-12)
        assert np.array_equal(a.utilization > 0, b.utilization > 0)


@pytest.mark.parametrize("dims", [(4, 4), (6, 4, 2), (4, 3, 2, 2)], ids=str)
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_utilization_timeline_matches_the_numpy_engine(dims, integer):
    traffic = _messages(3, dims, 40, integer=integer)
    want = rn.simulate_traffic(dims, traffic, record_utilization=True)
    got = tn.simulate_traffic(dims, traffic, record_utilization=True, device=CPU)
    _assert_timelines_match(got, want)
    np.testing.assert_allclose(got.makespan, want.makespan, rtol=RTOL)
    plain = tn.simulate_traffic(dims, traffic, device=CPU)
    assert plain.timeline == [] and plain.steps == got.steps
    assert np.array_equal(plain.flow_completion, got.flow_completion)


def test_utilization_timeline_on_adaptive_and_explicit_capacity_paths():
    dims = (8, 4)
    traffic = rn.hotspot_line(dims)
    _assert_timelines_match(tn.simulate_traffic(dims, traffic, mode="adaptive", record_utilization=True, device=CPU),
                            rn.simulate_traffic(dims, traffic, mode="adaptive", record_utilization=True))
    jfab, pfab = rn.HyperXFabric((4, 3), (1, 2)), tn.HyperXFabric((4, 3), (1, 2), link_bw=1.0)
    a2a = rn.all_to_all((4, 3))
    _assert_timelines_match(tn.simulate_fabric_traffic(pfab, a2a, mode="dal", record_utilization=True, device=CPU),
                            rn.simulate_fabric_traffic(jfab, a2a, mode="dal", record_utilization=True))


def test_empty_traffic_records_no_timeline():
    z = np.zeros((0, 2), dtype=np.int64)
    res = tn.simulate_traffic((4, 4), (z, z, np.zeros(0)), record_utilization=True, device=CPU)
    assert res.steps == 0 and res.timeline == [] and res.makespan == 0.0
