"""Parity of the port's contention attribution (``repro_torch.obs.
contention``) with ``repro.obs.contention``, on the CPU.

With dyadic loads (every job of a power-of-two size) the report equals
the JAX package's exactly: every job record, the totals, the cross
traffic and the hotspot loads; otherwise within 1e-12 relative.  Hotspot
ties are the one deliberate difference: the port breaks equal loads
toward the lowest flat link index, the JAX package leaves them to
``np.argpartition``.  So the hotspot loads are compared in order, the
link set exactly above the last (boundary) load, and each boundary link
must carry that load.  The dashboard text and the JSON are equal where
the hotspot order is (``top_hotspots=0``), and line for line over the
jobs otherwise.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.obs import contention as jax_contention  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import contention as port_contention  # noqa: E402

CPU = "cpu"
# (machine, [(job, geometry, oriented, offset)]): job 0 spills around the
# 6-ring through job 1's cells.
DYADIC = ((6, 6, 4), [(0, (4, 2, 2), (4, 2, 2), (0, 0, 0)), (1, (2, 2, 2), (2, 2, 2), (4, 0, 0)),
                      (2, (2, 2, 1), (2, 1, 2), (0, 3, 0)), (3, (2, 1, 1), (1, 1, 2), (5, 5, 2))])
MIXED = ((6, 6, 4), [(0, (3, 2, 2), (3, 2, 2), (0, 0, 0)), (1, (4, 2, 1), (4, 2, 1), (0, 2, 2)),
                     (7, (6, 1, 1), (1, 6, 1), (5, 0, 3))])


def _machines(case):
    dims, jobs = case
    jm, pm = rn.MachineState(dims), tn.MachineState(dims, device=CPU)
    for jid, g, o, off in jobs:
        jm.commit(jid, g, o, off)
        pm.commit(jid, g, o, off)
    return jm, pm


def _flat_index(h, dims):
    return np.ravel_multi_index((h.dim, h.direction) + tuple(h.cell), (len(dims), 2) + tuple(dims))


def _assert_hotspots(got, want, total, index):
    """Load sequence exact; set exact above the boundary load; boundary
    links carry it; shares equal at each link."""
    assert [h.load for h in got] == [h.load for h in want]
    if not want:
        return
    edge = want[-1].load
    assert {index(h) for h in got if h.load > edge} == {index(h) for h in want if h.load > edge}
    for h in got:
        assert total[index(h)] == h.load
    by_link = {index(h): h.shares for h in want}
    for h in got:
        if index(h) in by_link:
            assert h.shares == by_link[index(h)]
    idx = [index(h) for h in got if h.load == edge]
    assert idx == sorted(idx)  # ties toward the lowest flat index


def _compare(got, want, exact):
    assert got.dims == want.dims and len(got.jobs) == len(want.jobs)
    for a, b in zip(got.jobs, want.jobs):
        ta, tb = dataclasses.astuple(a), dataclasses.astuple(b)
        if exact:
            assert ta == tb
        else:
            for x, y in zip(ta, tb):
                if isinstance(y, float):
                    assert x == pytest.approx(y, rel=1e-12, abs=1e-12)
                else:
                    assert x == y
    for name in ("total_load", "max_link_load", "cross_load"):
        if exact:
            assert getattr(got, name) == getattr(want, name), name
        else:
            assert getattr(got, name) == pytest.approx(getattr(want, name), rel=1e-12), name


@pytest.mark.parametrize("top", [5, 40])
def test_attribution_of_dyadic_jobs_equals_jax(top):
    jm, pm = _machines(DYADIC)
    want = jax_contention.attribute_contention(jm, top_hotspots=top)
    got = obs.attribute_contention(pm, top_hotspots=top)
    _compare(got, want, exact=True)
    total = jm.traffic_loads().ravel()
    _assert_hotspots(got.hotspots, want.hotspots, total, lambda h: _flat_index(h, DYADIC[0]))
    assert got.cross_load > 0.0 and {j.job_id for j in got.jobs if j.cross_load > 0} == {0}
    assert sum(j.self_load + j.cross_load for j in got.jobs) == got.total_load == float(total.sum())


def test_attribution_of_non_dyadic_jobs_within_tolerance():
    jm, pm = _machines(MIXED)
    want = jax_contention.attribute_contention(jm)
    got = obs.attribute_contention(pm)
    _compare(got, want, exact=False)
    np.testing.assert_allclose([h.load for h in got.hotspots], [h.load for h in want.hotspots], rtol=1e-12)


def test_attribution_at_node_level_and_the_acceptance_pair():
    """The avoidable-contention pair of ``tests/test_obs.py`` on an 8^3
    machine: the optimal cube has nothing avoidable, the flat slab pays."""
    jm, pm = rn.MachineState((8, 8, 8)), tn.MachineState((8, 8, 8), device=CPU)
    for m in (jm, pm):
        assert m.allocate(0, (4, 4, 4)) is not None and m.allocate(1, (8, 8, 1)) is not None
    want = jax_contention.attribute_contention(jm)
    got = obs.attribute_contention(pm)
    _compare(got, want, exact=True)
    good, bad = got.jobs
    assert good.avoidable_ratio == 1.0 and good.certified and bad.avoidable_ratio > 1.0
    for unit in [(2, 2, 2)]:
        _compare(obs.attribute_contention(pm, unit_node_dims=unit),
                 jax_contention.attribute_contention(jm, unit_node_dims=unit), exact=True)


def test_attribute_traffic_explicit_loads_and_validation():
    dims = (4, 4, 2)
    rng = np.random.default_rng(2)
    loads = {j: rng.integers(0, 4, (3, 2) + dims).astype(float) / 4 for j in (3, 1)}
    want = jax_contention.attribute_traffic(dims, loads, top_hotspots=7)
    got = obs.attribute_traffic(dims, loads, top_hotspots=7, device=CPU)
    _compare(got, want, exact=True)
    total = (loads[1] + loads[3]).ravel()
    _assert_hotspots(got.hotspots, want.hotspots, total, lambda h: _flat_index(h, dims))
    assert all(j.units == 0 and j.optimal_geometry is None for j in got.jobs)
    tensors = {j: torch.from_numpy(v) for j, v in loads.items()}
    assert obs.attribute_traffic(dims, tensors, device=CPU).to_dict() == got.to_dict() | {
        "hotspots": got.to_dict()["hotspots"][:5]}
    with pytest.raises(ValueError, match="shape"):
        obs.attribute_traffic((4, 4), {0: np.zeros((2, 2, 4, 4, 9))}, device=CPU)
    empty = obs.attribute_traffic(dims, {}, device=CPU)
    assert empty.jobs == () and empty.hotspots == () and empty.total_load == 0.0


def test_hotspot_ties_go_to_the_lowest_flat_link():
    """A job covering a whole 4x4 torus loads every link alike: the top-k
    are the first k links of the flat (dim, direction, cell) layout."""
    pm = tn.MachineState((4, 4), device=CPU)
    pm.allocate(0, (4, 4))
    rep = obs.attribute_contention(pm, top_hotspots=6)
    assert [_flat_index(h, (4, 4)) for h in rep.hotspots] == list(range(6))
    assert len({h.load for h in rep.hotspots}) == 1
    jm = rn.MachineState((4, 4))
    jm.allocate(0, (4, 4))
    want = jax_contention.attribute_contention(jm, top_hotspots=6)
    assert [h.load for h in rep.hotspots] == [h.load for h in want.hotspots]
    none = obs.attribute_contention(pm, top_hotspots=0)
    assert none.hotspots == ()


def test_dashboard_and_json_match_jax():
    jm, pm = _machines(DYADIC)
    for top in (0, 5):
        want = jax_contention.attribute_contention(jm, top_hotspots=top)
        got = obs.attribute_contention(pm, top_hotspots=top)
        text, want_text = obs.render_dashboard(got), jax_contention.render_dashboard(want)
        n_jobs = 4 + len(got.jobs)
        assert text.splitlines()[:n_jobs] == want_text.splitlines()[:n_jobs]
        assert len(text.splitlines()) == len(want_text.splitlines())
        if top == 0:
            assert text == want_text
            assert got.to_json() == want.to_json()
            assert obs.render_dashboard(got, width=12) == jax_contention.render_dashboard(want, width=12)
    doc = json.loads(got.to_json())
    assert doc["dims"] == [6, 6, 4] and len(doc["jobs"]) == 4 and len(doc["hotspots"]) == 5


def test_own_link_mask_and_dispatch_count(tmp_path):
    jm, pm = _machines(DYADIC)
    for jid, p in pm.placements.items():
        got = port_contention._own_link_mask(pm.dims, p.oriented, p.offset, CPU)
        assert np.array_equal(got.numpy(), jax_contention._own_link_mask(jm.dims, p.oriented, p.offset))
    before = obs.DISPATCHES[("attribute_contention", "cpu")]
    rep = obs.attribute_contention(pm)
    rep.to_json(str(tmp_path / "r.json"))
    assert json.loads((tmp_path / "r.json").read_text()) == rep.to_dict()
    assert obs.DISPATCHES[("attribute_contention", "cpu")] == before + 1
