"""Parity of the port's rank mapping (``repro_torch.network.mapping``)
with the JAX package, on the CPU: strategy, coordinates and score exactly,
for halo, pairing, ring and all-to-all traffic, with ``refine`` on and
off, against the NumPy path and the ``xla`` backend's batched scorer."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.network import mapping as jax_mapping  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch.network import backend as port_backend  # noqa: E402
from repro_torch.network import mapping as port_mapping  # noqa: E402

CPU = "cpu"
CASES = [  # (machine, oriented, offset, logical grid)
    ((4, 8), (2, 8), (0, 0), (8, 2)),
    ((4, 4, 3, 2), (4, 3, 2, 1), (0, 1, 0, 1), None),
    ((6, 4, 2), (3, 4, 2), (1, 0, 0), (2, 3, 4)),
    ((4, 4, 4), (4, 2, 2), (1, 2, 3), None),
    ((7, 2, 2, 2), (7, 2, 1, 1), (0, 0, 1, 0), None),
]
PATTERNS = ["halo", "pairing", "ring", "all-to-all"]


def _same(got, want):
    assert got.strategy == want.strategy
    assert np.array_equal(got.coords, want.coords) and not got.coords.flags.writeable
    assert (got.score.congestion, got.score.dilation) == (want.score.congestion, want.score.dilation)
    assert (got.identity_score.congestion, got.identity_score.dilation) == \
        (want.identity_score.congestion, want.identity_score.dilation)
    assert np.array_equal(got.loads, want.loads) and not got.loads.flags.writeable
    assert (got.dims, got.oriented, got.offset, got.logical_dims, got.pattern, got.wrap) == \
        (want.dims, want.oriented, want.offset, want.logical_dims, want.pattern, want.wrap)
    for a, b in zip(got.machine_traffic(), want.machine_traffic()):
        assert np.array_equal(a, b)
    assert got.recovered_congestion == want.recovered_congestion and got.num_ranks == want.num_ranks


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("refine", [True, False])
def test_map_ranks_matches_jax(case, pattern, refine):
    dims, oriented, offset, logical = CASES[case]
    want = rn.map_ranks(dims, oriented, offset, logical, pattern=pattern, refine=refine)
    got = tn.map_ranks(dims, oriented, offset, logical, pattern=pattern, refine=refine, device=CPU)
    _same(got, want)


@pytest.mark.parametrize("case, patterns", [(0, PATTERNS), (4, ["pairing"])])
def test_map_ranks_matches_the_xla_backend(case, patterns):
    dims, oriented, offset, logical = CASES[case]
    for pattern in patterns:
        want = rn.map_ranks(dims, oriented, offset, logical, pattern=pattern, backend="xla")
        _same(tn.map_ranks(dims, oriented, offset, logical, pattern=pattern, device=CPU), want)


def test_the_refinement_helps_somewhere_and_matches_jax():
    dims, oriented = (7, 2, 2, 2), (7, 2, 1, 1)
    want = rn.map_ranks(dims, oriented, (0, 0, 1, 0), pattern="pairing")
    got = tn.map_ranks(dims, oriented, (0, 0, 1, 0), pattern="pairing", device=CPU)
    _same(got, want)
    assert got.strategy.startswith("greedy(")
    seed = port_mapping.identity_mapping(dims, oriented, (0, 0, 0, 0))
    traffic = port_mapping.pattern_traffic(oriented, "pairing")
    for rounds, ranks in ((1, 4), (3, 12)):
        c1, s1, i1 = port_mapping.greedy_refine(dims, seed, traffic, max_rounds=rounds, max_ranks=ranks, device=CPU)
        c2, s2, i2 = jax_mapping.greedy_refine(dims, seed, traffic, max_rounds=rounds, max_ranks=ranks)
        assert np.array_equal(c1, c2) and (s1.congestion, s1.dilation, i1) == (s2.congestion, s2.dilation, i2)


def test_explicit_traffic_wrap_and_errors():
    rng = np.random.default_rng(0)
    traffic = (rng.integers(0, 12, 30), rng.integers(0, 12, 30), rng.integers(1, 4, 30).astype(np.float64))
    want = rn.map_ranks((4, 4, 3), (2, 2, 3), (1, 1, 0), traffic=traffic, wrap=(True, False, True))
    got = tn.map_ranks((4, 4, 3), (2, 2, 3), (1, 1, 0), traffic=traffic, wrap=(True, False, True), device=CPU)
    _same(got, want)
    for package, kw in ((rn, {}), (tn, {"device": CPU})):
        with pytest.raises(ValueError, match="does not fit"):
            package.map_ranks((4, 4), (5, 1), **kw)
        with pytest.raises(ValueError, match="ranks"):
            package.map_ranks((4, 4), (2, 2), logical_dims=(3,), **kw)
        with pytest.raises(ValueError, match="unknown mapping pattern"):
            package.map_ranks((4, 4), (2, 2), pattern="shuffle", **kw)
    one = tn.map_ranks((4, 4), (1, 1), device=CPU)
    assert one.strategy == "identity" and one.score.congestion == 0.0


def test_scoring_in_chunks_gives_the_same_rows(monkeypatch):
    """The catalogue's scores are row-exact, so chunking cannot change
    them: a budget of one candidate per chunk equals one batch."""
    dims, oriented = (4, 4, 3, 2), (4, 3, 2, 1)
    orders = list(port_mapping.axis_permutation_orders(oriented))
    coords = np.stack([port_mapping.axis_order_coords(dims, oriented, (0, 1, 0, 1), p, r) for p, r in orders])
    traffic = port_mapping.pattern_traffic(oriented, "halo")
    whole = port_backend.score_candidates(dims, coords, traffic, device=CPU)
    monkeypatch.setattr(port_backend, "SCORE_BUDGET_BYTES", 1)
    assert port_backend.score_chunk(dims, traffic[0].shape[0]) == 1
    one_by_one = port_backend.score_candidates(dims, coords, traffic, device=CPU)
    assert all(np.array_equal(a, b) for a, b in zip(whole, one_by_one))
    for c, cong, dil in zip(coords, *whole):
        ref = jax_mapping.score_mapping(dims, c, traffic)
        assert (cong, dil) == (ref.congestion, ref.dilation)
    monkeypatch.undo()
    assert port_backend.score_chunk((16, 16, 12, 8, 2), 81920) > 1


@pytest.mark.parametrize("oriented", [(4, 3, 2, 1), (1, 4, 1, 1), (2, 2, 2, 2)])
def test_enumerations_and_hops_match_jax(oriented):
    dims, offset = (4, 4, 3, 2), (3, 2, 1, 1)
    assert list(port_mapping.axis_permutation_orders(oriented)) == list(jax_mapping.axis_permutation_orders(oriented))
    for perm, rev in port_mapping.axis_permutation_orders(oriented):
        assert np.array_equal(port_mapping.axis_order_coords(dims, oriented, offset, perm, rev),
                              jax_mapping.axis_order_coords(dims, oriented, offset, perm, rev))
    for name in ("identity_mapping", "snake_mapping", "placement_cell_coords"):
        got = getattr(port_mapping, name)(dims, oriented, offset)
        assert np.array_equal(got, getattr(jax_mapping, name)(dims, oriented, offset))
    coords = port_mapping.snake_mapping(dims, oriented, offset)
    for axis in range(len(oriented)):
        for wrap in (None, (True, False, True, True)):
            assert port_mapping.mesh_axis_hops(dims, coords, oriented, axis, wrap) == \
                jax_mapping.mesh_axis_hops(dims, coords, oriented, axis, wrap)
    traffic = port_mapping.pattern_traffic(oriented, "ring")
    for a, b in zip(port_mapping.mapping_traffic(coords, traffic), jax_mapping.mapping_traffic(coords, traffic)):
        assert np.array_equal(a, b)
    assert np.array_equal(port_mapping.mapping_loads(dims, coords, traffic, device=CPU),
                          jax_mapping.mapping_loads(dims, coords, traffic))
    src, dst = coords[traffic[0]], coords[traffic[1]]
    assert np.array_equal(port_mapping.toroidal_hops(dims, src, dst, (True, False, True, False)),
                          jax_mapping.toroidal_hops(dims, src, dst, (True, False, True, False)))
    with pytest.raises(ValueError, match="ranks"):
        port_mapping.mesh_axis_hops(dims, coords[:-1], oriented, 0)


def test_map_ranks_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tn.map_ranks((4, 4), (2, 2))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tn.greedy_refine((4, 4), np.array([[0, 0], [1, 1]]), ([0], [1], np.ones(1)))
