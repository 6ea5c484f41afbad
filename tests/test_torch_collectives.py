"""Parity of the port's collective cost model and what the fleet planner
builds on (``repro_torch.network.collectives``, ``netsim.simulate_phases``,
the slice half of ``network.fabric``, ``analysis.analytic`` and
``distributed.sharding``) with the JAX package, on the CPU.

Every quantity here is a Python float or an int computed in the same order
in both packages, so the comparisons are exact (``==``), except where a
drain through the flow simulator is involved (within 1e-9 relative, the
drain's contract in ``tests/test_torch_network.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.network as rn  # noqa: E402
from repro.analysis import analytic as jax_analytic  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.distributed.sharding import validate_partition_spec as jax_validate  # noqa: E402
from repro.network.fabric import DEFAULT_LINK_BW  # noqa: E402

import repro_torch.network as tn  # noqa: E402
from repro_torch.analysis import analytic as port_analytic  # noqa: E402
from repro_torch.configs import SHAPES as PORT_SHAPES  # noqa: E402
from repro_torch.configs import get_arch as port_get_arch  # noqa: E402
from repro_torch.distributed.sharding import validate_partition_spec as port_validate  # noqa: E402

CPU = "cpu"
ARCHS = ["granite-3-8b", "llama3-70b", "qwen1.5-110b", "nemotron-4-340b", "command-r-35b",
         "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "internvl2-1b", "musicgen-large",
         "rwkv6-3b", "zamba2-2.7b"]
# tests/test_planner.py's pods: (dims, chips), every chip count admits a cuboid
SLICE_CASES = [
    ((4, 2), 4), ((4, 2), 8), ((4, 4), 4), ((4, 4), 8),
    ((2, 2, 2), 4), ((2, 2, 2), 8), ((4, 2, 2), 8), ((6, 2), 4),
    ((2, 2, 2, 2), 8), ((2, 2, 2, 2), 16),
]
# logical meshes over the same pods: (pod dims, wrap, axis sizes, order hint)
AXIS_CASES = [
    ((4, 4), (True, True), {"data": 4, "model": 4}, None),
    ((4, 4), (True, False), {"data": 4, "model": 4}, ["model", "data"]),
    ((4, 2, 2), (True, True, True), {"data": 4, "fsdp": 2, "tensor": 2}, ["tensor", "fsdp", "data"]),
    ((2, 2, 2, 2), (True,) * 4, {"data": 1, "fsdp": 16, "tensor": 1, "expert": 1}, None),
    ((2, 2, 2, 2), (True, False, True, False), {"data": 4, "model": 4}, ["model", "data"]),
    ((6, 2), (False, True), {"data": 6, "model": 2}, None),
]
COLLECTIVES = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"]


def _fabrics(dims, wrap, link_bw=DEFAULT_LINK_BW, double=False):
    return (rn.TorusFabric(tuple(dims), tuple(wrap), link_bw, double),
            tn.TorusFabric(tuple(dims), tuple(wrap), link_bw, double))


def _embeddings(a):
    return [(e.size, e.stride, e.wrapped) for e in a.embeddings]


@pytest.mark.parametrize("size, stride, wrapped", [(1, 1, True), (2, 1, True), (4, 1, False),
                                                    (8, 2, True), (16, 3, False), (6, 1, True)])
def test_ring_times_match_jax(size, stride, wrapped):
    je = rn.AxisEmbedding(size, stride, wrapped)
    pe = tn.AxisEmbedding(size, stride, wrapped)
    assert pe.ring_bw_factor == je.ring_bw_factor
    for name in COLLECTIVES:
        for nbytes in (1.0, 3.0e9, 186810105856.0):
            assert tn.COLLECTIVE_TIME[name](nbytes, pe, 2e9) == rn.COLLECTIVE_TIME[name](nbytes, je, 2e9)


@pytest.mark.parametrize("case", range(len(AXIS_CASES)))
@pytest.mark.parametrize("mapped", [False, True])
def test_assign_axes_and_cost_model_match_jax(case, mapped):
    dims, wrap, axes, hint = AXIS_CASES[case]
    jf, pf = _fabrics(dims, wrap)
    jm = pm = None
    if mapped:
        logical = tuple(axes.values())
        jm = rn.map_ranks(dims, dims, logical_dims=logical, pattern="halo", wrap=wrap, refine=False)
        pm = tn.map_ranks(dims, dims, logical_dims=logical, pattern="halo", wrap=wrap, refine=False, device=CPU)
        assert pm.strategy == jm.strategy and np.array_equal(pm.coords, jm.coords)
    ja = rn.assign_axes(jf, axes, order_hint=hint, mapping=jm)
    pa = tn.assign_axes(pf, axes, order_hint=hint, mapping=pm)
    assert (pa.axis_names, pa.axis_sizes, pa.phys_groups) == (ja.axis_names, ja.axis_sizes, ja.phys_groups)
    assert _embeddings(pa) == _embeddings(ja)
    jc, pc = rn.CollectiveCostModel(jf, ja), tn.CollectiveCostModel(pf, pa)
    for axis in axes:
        assert pc.effective_axis_bandwidth(axis) == jc.effective_axis_bandwidth(axis)
        for name in COLLECTIVES:
            assert pc.time(name, axis, 7.5e8) == jc.time(name, axis, 7.5e8)


def test_assign_axes_refuses_what_jax_refuses():
    jf, pf = _fabrics((4, 2), (True, True))
    for axes, hint in (({"data": 3, "model": 2}, None), ({"data": 4, "model": 2}, ["data"])):
        with pytest.raises(ValueError) as want:
            rn.assign_axes(jf, axes, order_hint=hint)
        with pytest.raises(ValueError) as got:
            tn.assign_axes(pf, axes, order_hint=hint)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dims, axis, double", [((8,), 0, False), ((4, 4), 1, False), ((6, 2, 2), 0, True),
                                                 ((4, 2, 2), 1, True), ((5, 3), 0, False)])
def test_simulated_ring_all_reduce_matches_closed_form_and_jax(dims, axis, double):
    nbytes = 96.0
    got = tn.simulated_ring_all_reduce_time(dims, axis, nbytes, link_bw=2.0, double_link_on_2=double, device=CPU)
    want = rn.simulated_ring_all_reduce_time(dims, axis, nbytes, link_bw=2.0, double_link_on_2=double)
    assert math.isclose(got, want, rel_tol=1e-9)
    n = dims[axis]
    if n > 2:  # a contiguous wrapped ring: the closed form exactly
        assert math.isclose(got, tn.ring_all_reduce_time(nbytes, tn.AxisEmbedding(n), 2.0), rel_tol=1e-12)


@pytest.mark.parametrize("dims", [(4, 2), (4, 4, 2), (3, 3, 2)])
def test_simulate_phases_matches_the_numpy_engine(dims):
    rng = np.random.default_rng(7)
    cells = tn.vertices(dims)
    random = (cells, cells[rng.permutation(len(cells))], rng.integers(1, 5, len(cells)).astype(np.float64))
    ring = tn.ring_all_reduce_phases(dims, 0, 24.0)
    phases = [random] + ring + [random, tn.bisection_pairing(dims, 2.0)]
    jax_phases = [random] + rn.ring_all_reduce_phases(dims, 0, 24.0) + [random, rn.bisection_pairing(dims, 2.0)]
    got = tn.simulate_phases(dims, phases, link_bw=2.0, device=CPU)
    want = rn.simulate_phases(dims, jax_phases, link_bw=2.0)
    assert len(got.phases) == len(want.phases) == len(phases)
    for a, b in zip(got.phases, want.phases):
        assert math.isclose(a.makespan, b.makespan, rel_tol=1e-9) and a.steps == b.steps
    assert math.isclose(got.total_time, want.total_time, rel_tol=1e-9)
    # the memo drains one tuple once: the repeated phases share one result
    assert got.phases[0] is got.phases[len(ring) + 1]
    if len(ring) > 1:
        assert got.phases[1] is got.phases[2]


@pytest.mark.parametrize("dims, chips", SLICE_CASES)
@pytest.mark.parametrize("convention", ["tpu", "bgq", "half-wrapped"])
def test_slice_geometries_match_jax(dims, chips, convention):
    if convention == "tpu":
        jp, pp = _fabrics(dims, (True,) * len(dims))
    elif convention == "bgq":
        jp, pp = _fabrics(dims, (True,) * len(dims), link_bw=2e9, double=True)
    else:
        jp, pp = _fabrics(dims, tuple(k % 2 == 0 for k in range(len(dims))))
    ranked = tn.ranked_slice_geometries(pp, chips, device=CPU)
    assert ranked == rn.ranked_slice_geometries(jp, chips)
    assert tn.best_slice_geometry(pp, chips, device=CPU) == rn.best_slice_geometry(jp, chips)
    assert tn.worst_slice_geometry(pp, chips) == rn.worst_slice_geometry(jp, chips)
    for g, _ in ranked:
        ps, js = tn.slice_fabric(pp, g), rn.slice_fabric(jp, g)
        assert (ps.dims, ps.wrap, ps.link_bw, ps.double_link_on_2) == (js.dims, js.wrap, js.link_bw, js.double_link_on_2)


def test_slice_planning_refuses_what_jax_refuses():
    jp, pp = _fabrics((4, 2), (True, True))
    for port_call, jax_call in ((lambda: tn.slice_fabric(pp, (8, 1)), lambda: rn.slice_fabric(jp, (8, 1))),
                                (lambda: tn.slice_fabric(pp, (2, 2, 2)), lambda: rn.slice_fabric(jp, (2, 2, 2))),
                                (lambda: tn.worst_slice_geometry(pp, 7), lambda: rn.worst_slice_geometry(jp, 7))):
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        tn.slice_fabric(jp, (2, 2))  # a JAX fabric is not the port's TorusFabric


def _decode_cache_bytes(cfg, shape):
    if shape.kind != "decode" or cfg.is_attention_free:
        return 0.0
    return 2.0 * cfg.n_layers * shape.global_batch * shape.seq_len * cfg.n_kv_heads * cfg.resolved_head_dim * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_cost_matches_jax_exactly(arch):
    jc, pc = jax_get_arch(arch), port_get_arch(arch)
    assert pc.param_count() == jc.param_count()
    assert sorted(PORT_SHAPES) == sorted(JAX_SHAPES)
    for name in sorted(JAX_SHAPES):
        js, ps = JAX_SHAPES[name], PORT_SHAPES[name]
        for micro in (1, 4):
            want = jax_analytic.cell_cost(jc, js, float(jc.param_count()), _decode_cache_bytes(jc, js), micro)
            got = port_analytic.cell_cost(pc, ps, float(pc.param_count()), _decode_cache_bytes(pc, ps), micro)
            assert (got.flops_compiled, got.flops_useful, got.bytes_hbm) == \
                (want.flops_compiled, want.flops_useful, want.bytes_hbm), (arch, name, micro)
            assert got.breakdown == want.breakdown
    assert (port_analytic.ATTN_KV_BLOCK, port_analytic.RWKV_CHUNK) == (jax_analytic.ATTN_KV_BLOCK, jax_analytic.RWKV_CHUNK)


SPECS = [
    ((("data", "fsdp"), "tensor"), ["data", "fsdp", "tensor"]),
    (("tensor", None, "fsdp"), {"data": 2, "fsdp": 2, "tensor": 2, "expert": 1}),
    ((None, None), ["data"]),
    (("data", "data"), {"data": 2}),
    ((("fsdp", "fsdp"), None), ["fsdp"]),
    ((("data", "tensor"), "tensor"), ["data", "tensor"]),
    (("model",), ["data", "fsdp", "tensor", "expert"]),
    ((("data", "pod"), None), ("data",)),
]


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_validate_partition_spec_matches_jax(case):
    spec, axes = SPECS[case]
    try:
        jax_validate(spec, axes)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port_validate(spec, axes)
        assert str(got.value) == str(exc)
    else:
        port_validate(spec, axes)
