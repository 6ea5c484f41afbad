"""The port's roofline layer (``repro_torch.analysis.roofline`` and
``axis_attribution``) against the JAX package's: the report's terms with
JAX's constants handed to the H100 profile, the matmul parameter count,
the FLOP counter against the analytic model (as tests/test_roofline.py:66-86
holds XLA's count), a hand-counted trace of DTensor collectives by type and
axis, the axis classification, the contention-aware pricing and the
bilinear calibration."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax

from repro.analysis import axis_attribution as jax_axis
from repro.analysis import roofline as jax_roofline
from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.analysis import analytic, axis_attribution, h100, roofline
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import bilinear
from repro_torch.models.model import build_model

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def jax_constants(monkeypatch):
    """The JAX roofline's v5e rates handed to the H100 profile."""
    monkeypatch.setattr(h100, "PEAK_FLOPS", jax_roofline.PEAK_FLOPS)
    monkeypatch.setattr(h100, "HBM_BW", jax_roofline.HBM_BW)


@pytest.mark.parametrize("case", [
    dict(hlo_flops=197e12, hlo_bytes=819e9 / 2, collective_bytes=50e9 * 2, model_flops=0.5 * 197e12 * 256),
    dict(hlo_flops=3.1e14, hlo_bytes=5.5e11, collective_bytes=1.8e9, model_flops=5.0e16),
    dict(hlo_flops=0.0, hlo_bytes=0.0, collective_bytes=0.0, model_flops=0.0),
])
def test_report_terms_equal_jax(jax_constants, case):
    """tests/test_roofline.py:89-103's case and two more: every term,
    the bottleneck and the ratios equal JAX's exactly."""
    common = dict(arch="x", shape="train_4k", mesh="single", chips=256, collectives={}, **case)
    want = jax_roofline.RooflineReport(**common).to_json()
    got = roofline.RooflineReport(link_bw=jax_roofline.LINK_BW, **common).to_json()
    assert got.pop("link_bw") == jax_roofline.LINK_BW
    assert got == want


def test_report_reads_the_h100_profile():
    r = roofline.RooflineReport(arch="x", shape="s", mesh="m", chips=8, hlo_flops=989e12, hlo_bytes=3.35e12,
                                collective_bytes=25e9, collectives={}, model_flops=0.0, link_bw=25e9)
    assert (r.compute_term, r.memory_term, r.collective_term) == (1.0, 1.0, 1.0)


def test_link_rate_has_no_default():
    with pytest.raises(TypeError, match="link_bw"):
        roofline.RooflineReport(arch="x", shape="s", mesh="m", chips=1, hlo_flops=1.0, hlo_bytes=1.0,
                                collective_bytes=1.0, collectives={}, model_flops=1.0)


@pytest.mark.parametrize("name", sorted(jax_all_archs()))
def test_matmul_param_count_equals_jax(name):
    jparams = jax.eval_shape(lambda: jax_build_model(jax_get_arch(name)).init(jax.random.key(0)))
    got = roofline.matmul_param_count(build_model(get_arch(name)).init_shapes())
    assert got == jax_roofline.matmul_param_count(jparams)


def test_model_flops_per_step_equals_jax():
    for args in [(8.2e9, 1e6), (1.3e10, 4096.0, 0.27, False), (3.4e11, 2 ** 20, 1.0, True)]:
        assert roofline.model_flops_per_step(*args) == jax_roofline.model_flops_per_step(*args)


def _meta_batch(cfg, B, S):
    if cfg.frontend == "audio":
        return {"frame_embeds": torch.empty(B, S, cfg.d_model, dtype=torch.bfloat16, device="meta"),
                "targets": torch.empty(B, S, cfg.n_codebooks, dtype=torch.long, device="meta")}
    return {"tokens": torch.empty(B, S, dtype=torch.long, device="meta")}


@pytest.mark.parametrize("name,S,rel", [
    ("granite-3-8b", 128, 0.15), ("qwen1.5-110b", 128, 0.15), ("musicgen-large", 128, 0.15),
    ("rwkv6-3b", 32, 0.2),
])
def test_flop_counter_forward_within_analytic(name, S, rel):
    """A 2-layer full-width forward on meta tensors (nothing computed):
    FlopCounterMode's count within 15% of analytic.forward_flops (rwkv6
    at one chunk, 20%), the tolerances of tests/test_roofline.py:66-86."""
    cfg = dataclasses.replace(get_arch(name), n_layers=2)
    model = build_model(cfg)
    _, counts = roofline.flop_count(model.forward, model.init_shapes(), _meta_batch(cfg, 1, S))
    expected = sum(analytic.forward_flops(cfg, 1, S, compiled=True).values())
    assert counts["flops"] == pytest.approx(expected, rel=rel), (counts, expected)


TRACE_PROG = textwrap.dedent(
    """
    import json
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh, DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.analysis.axis_attribution import per_axis_collectives
    from repro_torch.analysis.roofline import CollectiveTrace, LocalFlopCounter

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    mesh = init_device_mesh("cpu", (2, 2, 4), mesh_dim_names=("pod", "data", "model"))
    flat = DeviceMesh("cpu", mesh.mesh.reshape(4, 4), mesh_dim_names=("pod+data", "model"))
    x = DTensor.from_local(torch.zeros(8, 16), flat, [Shard(0), Replicate()], run_check=False)  # (32, 16)
    w = DTensor.from_local(torch.zeros(16, 6), flat, [Replicate(), Shard(1)], run_check=False)  # (16, 24)
    p = DTensor.from_local(torch.zeros(32, 24), flat, [Replicate(), Partial()], run_check=False)
    other = dist.new_group([0, 4, 8, 12])  # the "data" ranks of the first pod... and the second
    with LocalFlopCounter() as flops, CollectiveTrace() as trace:
        y = x @ w  # no collective: rows over pod+data, columns over model
        g = x.redistribute(flat, [Replicate(), Replicate()])  # all-gather over pod+data: 32*16*4 B
        r = p.redistribute(flat, [Replicate(), Replicate()])  # all-reduce over model: 32*24*4 B
        s = p.redistribute(flat, [Replicate(), Shard(0)])  # reduce-scatter over model: 8*24*4 B
        t = torch.zeros(4, dtype=torch.float32)
        torch.ops._c10d_functional.wait_tensor(torch.ops._c10d_functional.all_reduce(t, "sum", other.group_name))
    print(json.dumps({"stats": trace.stats(), "flops": flops.counts(), "y": list(y.to_local().shape),
                      "per_axis": per_axis_collectives(trace, flat, {"pod": 2, "data": 2, "model": 4}),
                      "ranks": sorted({op.group_ranks for op in trace.ops})}))
    """
)


def test_traced_collectives_by_type_and_axis_hand_counted(tmp_path):
    """On a fake 16-rank (pod 2, data 2, model 4) mesh flattened to
    (pod+data, model): a local product traces nothing, a gather of the rows
    one all-gather over "pod+data" of its result bytes, a partial sum one
    all-reduce or reduce-scatter over "model"; a group that is no mesh
    dimension's ([0, 4, 8, 12], stride 4) is classified by its members as
    "pod+data" -- JAX's name for the fsdp groups.  The FLOPs counted are
    rank 0's: one (8, 16) x (16, 6) product."""
    script = tmp_path / "trace.py"
    script.write_text(TRACE_PROG)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    stats = got["stats"]
    assert stats["all-gather"] == {"count": 1, "bytes": 32 * 16 * 4}
    assert stats["all-reduce"] == {"count": 2, "bytes": 32 * 24 * 4 + 4 * 4}
    assert stats["reduce-scatter"] == {"count": 1, "bytes": 8 * 24 * 4}
    assert stats["all-to-all"] == stats["collective-permute"] == {"count": 0, "bytes": 0}
    assert got["per_axis"] == {
        "pod+data": {"bytes": 32 * 16 * 4 + 4 * 4, "count": 2},
        "model": {"bytes": 32 * 24 * 4 + 8 * 24 * 4, "count": 2},
    }
    assert got["y"] == [8, 6]
    assert got["flops"] == {"flops": 2 * 8 * 16 * 6, "aten.mm": 2 * 8 * 16 * 6}


MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"data": 4, "model": 8}]


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES, ids=lambda m: "x".join(map(str, m.values())))
def test_classify_axis_equals_jax(mesh_shape):
    total = 1
    for v in mesh_shape.values():
        total *= v
    for size in sorted({1, 2, 4, 8, 16, 32, 64, 256, 512, total}):
        for stride in sorted({1, 2, 4, 8, 16, 32, 256, 3}):
            assert axis_attribution.classify_axis(size, stride, mesh_shape) == \
                jax_axis.classify_axis(size, stride, mesh_shape), (size, stride)


@pytest.mark.parametrize("best", [True, False])
def test_contention_aware_term_equals_jax(best):
    mesh_shape = {"pod": 2, "data": 16, "model": 16}
    per_axis = {
        "model": {"bytes": 1.75e11, "count": 1068},
        "data": {"bytes": 6.6e9, "count": 58},
        "pod": {"bytes": 1.2e9, "count": 4},
        "pod+data": {"bytes": 9.9e9, "count": 282},
        "ALL": {"bytes": 3.0e6, "count": 2},
        "unknown(3,7)": {"bytes": 1.0e3, "count": 1},
        "expert": {"bytes": 5.0e5, "count": 1},
    }
    want = jax_axis.contention_aware_collective_term(per_axis, mesh_shape, best)
    got = axis_attribution.contention_aware_collective_term(
        per_axis, mesh_shape, jax_roofline.LINK_BW, jax_axis.DCI_BW, best)
    assert got == want
    bws = axis_attribution.axis_bandwidths(mesh_shape, jax_roofline.LINK_BW, jax_axis.DCI_BW, best)
    jbws = jax_axis.axis_bandwidths(mesh_shape, best)
    assert {k: v.effective_bw for k, v in bws.items()} == {k: v.effective_bw for k, v in jbws.items()}


@pytest.mark.parametrize("with_microbatches", [True, False])
def test_bilinear_reproduces_a_known_model_exactly(with_microbatches):
    """F(L, m) = a + bL + cm + dLm with dyadic coefficients, measured at
    the calibration points, is recovered at (Lf, mb) exactly; the linear
    model (prefill / decode cells) from depths alone; clipped at 0."""
    a, b, c, d = 1.5, 0.25, 3.0, 0.125
    F = lambda L, m: a + b * L + c * m + d * L * m
    L0, L1, Lf, mb = 2, 4, 40, 8
    if with_microbatches:
        meas = {(L, m): F(L, m) for L in (L0, L1) for m in (1, 2)}
        assert bilinear(meas, L0, L1, Lf, mb) == F(Lf, mb)
    else:
        meas = {(L, 1): F(L, 1) for L in (L0, L1)}
        assert bilinear(meas, L0, L1, Lf, 1) == F(Lf, 1)
    falling = {(L0, 1): 10.0, (L1, 1): 2.0}
    assert bilinear(falling, L0, L1, Lf, 1) == 0.0
