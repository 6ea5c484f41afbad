"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's: rank 0's step of reduced cells on fake process groups (each in a
child process, which holds one default group), the state bytes against the
JAX specs' bytes and the analytic terms against JAX's ``cell_cost``; for
every arch x cell x production mesh, the same without running a step; the
CLI's refusals; and the pinned import of the fake process group."""

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
from jax.sharding import AbstractMesh, NamedSharding

from repro.analysis import analytic as jax_analytic
from repro.analysis import roofline as jax_roofline
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_archs as jax_all_archs
from repro.configs import cells as jax_cells
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed.sharding import ShardingRules as JaxRules
from repro.launch.dryrun import MICROBATCHES as JAX_MICROBATCHES
from repro.launch.dryrun import _calib_depths as jax_calib_depths
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.analysis import analytic, roofline
from repro_torch.configs import SHAPES, get_arch
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import build_model

SRC = Path(__file__).resolve().parents[1] / "src"


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jax_bytes(specs, shapes, mesh_shape):
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    total = 0
    for spec, leaf in zip(jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "index")),
                          jax.tree.leaves(shapes), strict=True):
        n = 1
        for d in NamedSharding(mesh, spec).shard_shape(leaf.shape):
            n *= d
        total += n * leaf.dtype.itemsize
    return float(total)


def _jax_state(jcfg, shape, mesh_shape):
    """(state bytes, cache bytes, params) of a cell as JAX's dry-run counts
    them (launch/dryrun.py:123-170), over an AbstractMesh."""
    model = jax_build_model(jcfg)
    rules = JaxRules(jcfg, FakeMesh(mesh_shape))
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    pspecs = rules.params_specs(params)
    if shape.kind == "train":
        opt = jax.eval_shape(jax_adamw.init, params)
        return (2 * _jax_bytes(pspecs, params, mesh_shape)
                + 2 * _jax_bytes(rules.opt_specs(params), opt.m, mesh_shape)), 0.0, params
    if shape.kind == "prefill":
        return _jax_bytes(pspecs, params, mesh_shape), 0.0, params
    cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch, shape.seq_len))
    cache_bytes = _jax_bytes(rules.cache_specs(cache), cache, mesh_shape)
    return _jax_bytes(pspecs, params, mesh_shape) + cache_bytes, cache_bytes, params


def _jax_cell_cost(jcfg, shape, mesh_shape, microbatches):
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    _, cache_bytes, params = _jax_state(jcfg, shape, mesh_shape)
    return jax_analytic.cell_cost(jcfg, shape, jax_roofline.matmul_param_count(params),
                                  cache_bytes=cache_bytes * chips, microbatches=microbatches)


def test_fake_process_group_import_is_pinned():
    """The fake process group lives in a private module of torch; a torch
    upgrade that moves it shows here first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert callable(FakeStore)


def test_constants_and_calibration_depths_equal_jax():
    assert dryrun.MICROBATCHES == JAX_MICROBATCHES
    for name in sorted(jax_all_archs()):
        assert dryrun._calib_depths(get_arch(name)) == jax_calib_depths(jax_get_arch(name))


CELLS = [(name, shape, kind) for name in sorted(jax_all_archs()) for shape in jax_cells(jax_get_arch(name))
         for kind in ("single", "multi")]


@pytest.mark.parametrize("name,shape_name,kind", CELLS)
def test_state_bytes_and_analytic_terms_equal_jax(name, shape_name, kind):
    """Every arch x cell x production mesh, without running a step: the
    exact per-rank state bytes from the port's specs equal JAX's over an
    AbstractMesh, and the analytic terms equal JAX's cell_cost."""
    mesh_shape = production_mesh_shape(kind == "multi")
    cfg, jcfg = get_arch(name), jax_get_arch(name)
    state, cache = dryrun.cell_state_bytes(cfg, SHAPES[shape_name], ShardingRules(cfg, mesh_shape))
    want_state, want_cache, jparams = _jax_state(jcfg, JAX_SHAPES[shape_name], mesh_shape)
    assert (state, cache) == (want_state, want_cache)
    mb = dryrun.MICROBATCHES.get(name, 1) if SHAPES[shape_name].kind == "train" else 1
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    got = analytic.cell_cost(cfg, SHAPES[shape_name], roofline.matmul_param_count(build_model(cfg).init_shapes()),
                             cache_bytes=cache * chips, microbatches=mb)
    want = _jax_cell_cost(jcfg, JAX_SHAPES[shape_name], mesh_shape, mb)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


CELL_PROG = textwrap.dedent(
    """
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    data, model, kind, seq, batch, mb = sys.argv[1:7]
    data, model, seq, batch, mb = int(data), int(model), int(seq), int(batch), int(mb)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=data * model)
    mesh = init_device_mesh("cpu", (data, model), mesh_dim_names=("data", "model"))
    rec = dryrun.dryrun_cell(get_arch("granite-3-8b").reduced(), ShapeConfig("cell", seq, batch, kind), mesh,
                             mesh_kind="test", link_bw=50e9, device="cpu", variant={"microbatches": mb})
    print(json.dumps(rec))
    """
)


def _run_cell(tmp_path, *argv):
    script = tmp_path / "cell.py"
    script.write_text(CELL_PROG)
    out = subprocess.run([sys.executable, str(script), *map(str, argv)], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _check_record(rec, kind, seq, batch, mb, mesh_shape):
    jcfg = jax_get_arch("granite-3-8b").reduced()
    shape = JaxShape("cell", seq, batch, kind)
    want_state, _, _ = _jax_state(jcfg, shape, mesh_shape)
    assert rec["ok"] is True
    assert rec["bytes_per_device"] == want_state
    assert rec["memory_analysis"]["shard_bytes_allocated"] == want_state
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    cost = _jax_cell_cost(jcfg, shape, mesh_shape, mb)
    assert rec["hlo_flops"] == cost.flops_compiled / chips
    assert rec["hlo_bytes"] == cost.bytes_hbm / chips
    assert rec["model_flops"] == cost.flops_useful
    assert rec["flops_breakdown"] == cost.breakdown
    assert set(rec["collectives"]) == set(roofline.COLLECTIVES)
    assert rec["collective_bytes"] == roofline.total_collective_bytes(rec["collectives"])
    assert rec["flop_counter"]["flops"] > 0
    assert rec["chips"] == chips and rec["link_bw"] == 50e9


def test_one_by_one_mesh_train_step(tmp_path):
    """Counterpart of tests/test_roofline.py:106-136: reduced granite's
    train step with 2 microbatches on a (1, 1) mesh runs; nothing is
    sharded, so the state is every byte and no collective moves data."""
    rec = _run_cell(tmp_path, 1, 1, "train", 16, 2, 2)
    _check_record(rec, "train", 16, 2, 2, {"data": 1, "model": 1})
    assert rec["collective_bytes"] == 0


@pytest.mark.parametrize("kind,seq,batch,mb", [("train", 16, 4, 2), ("decode", 16, 4, 1)])
def test_reduced_cell_on_a_fake_two_by_four_mesh(tmp_path, kind, seq, batch, mb):
    """Reduced granite on a fake (data 2, model 4) mesh, calibrated: the
    state bytes equal JAX's specs' bytes, both as counted and as built, the
    analytic terms equal JAX's cell_cost, and collectives were traced on
    both axes."""
    rec = _run_cell(tmp_path, 2, 4, kind, seq, batch, mb)
    _check_record(rec, kind, seq, batch, mb, {"data": 2, "model": 4})
    assert set(rec["per_axis_collectives"]) == {"data", "model"}
    assert rec["collective_bytes"] > 0
    assert rec["notes"].endswith("microbatches [1, 2]" if kind == "train" else "microbatches [1]")


def test_cli_refuses_without_a_link_rate_and_a_cell(capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "granite-3-8b", "--shape", "train_4k"])
    with pytest.raises(SystemExit):
        dryrun.main(["--link-bw", "50e9"])


@pytest.mark.parametrize("shape,device", [("no_such_shape", "cpu"), ("decode_32k", "cuda")])
def test_cli_exits_non_zero_on_a_failed_cell(shape, device):
    """A cell that raises is reported, writes no record and fails the CLI,
    as dryrun.py:398-399: a shape the configs do not have; a card asked
    for where there is none (no fallback to the CPU).  The card case is run
    only where there is no card."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA run would not fail")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-3-8b", "--shape", shape,
           "--link-bw", "50e9", "--device", device]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode != 0
    assert f"[FAIL] granite-3-8b x {shape} x single" in out.stdout
    assert not (dryrun.RESULTS_DIR / f"granite-3-8b__{shape}__single.json").exists()


def test_records_go_to_build_not_benchmarks():
    assert dryrun.RESULTS_DIR.parts[-2:] == ("build", "dryrun")


def test_view_groups_pair_dimensions_by_their_products():
    assert dryrun.view_groups((2, 3, 4), (6, 4)) == [([0, 1], [0]), ([2], [1])]
    assert dryrun.view_groups((8, 64), (8, 4, 16)) == [([0], [0]), ([1], [1, 2])]
    assert dryrun.view_groups((1, 6), (2, 3, 1)) == [([0], []), ([1], [0, 1]), ([], [2])]


VIEW_CASES = [  # (shape, size, sharded tensor dim, mesh dim size, keeps the shard)
    ((8, 16), (8, 16), 1, 4, True),  # unchanged
    ((8, 64), (8, 4, 16), 1, 4, True),  # split, first piece divisible
    ((8, 128), (8, 8, 16), 1, 16, False),  # split of 8 KV heads over 16 ranks
    ((8, 128), (8, -1, 16), 1, 16, False),  # the same with an inferred size
    ((8, 4, 16), (8, 64), 1, 4, True),  # merge, the leftmost dimension sharded
    ((8, 4, 16), (8, 64), 2, 4, False),  # merge into a left neighbour
    ((4, 16, 64), (64, 64), 0, 2, True),  # batch merged with sequence
    ((4, 16, 64), (64, 64), 1, 2, False),
    ((6, 16), (96,), 0, 4, False),  # uneven leftmost dimension
]


@pytest.mark.parametrize("shape,size,dim,n,keeps", VIEW_CASES)
def test_view_keeps_shard_decides_from_shapes_and_placements(shape, size, dim, n, keeps):
    """Zero3Views replicates a view's input over the mesh dimensions this
    rule refuses, before the view, from shapes and placements alone."""
    from torch.distributed.tensor import Replicate, Shard

    pls = (Replicate(), Shard(dim))
    assert dryrun.view_keeps_shard(shape, size, pls, [2, n], 1) is keeps


def test_a_cell_whose_state_or_peak_fails_its_check_is_not_ok():
    """``dryrun_cell``'s checks: the local shards built hold the specs'
    state bytes (else the record is not ``ok`` and the CLI exits non-zero);
    the peak is checked against the card's memory only on the card."""
    from types import SimpleNamespace

    cpu = torch.device("cpu")
    good = SimpleNamespace(state_bytes=1024.0, allocated_bytes=1024.0)
    assert dryrun._checks(good, {"state_bytes": 1024.0}, cpu) == []
    bad = dryrun._checks(SimpleNamespace(state_bytes=1024.0, allocated_bytes=2048.0), {}, cpu)
    assert len(bad) == 1 and "2048" in bad[0] and "1024" in bad[0]


def test_cli_all_runs_its_part_of_the_matrix(monkeypatch):
    """``--all --part i/n`` runs every n-th arch x shape pair from the
    i-th: the parts cover the 36 pairs of the matrix once each."""
    from repro_torch.configs import all_archs, cells

    want = [(n, s) for n, a in sorted(all_archs().items()) for s in cells(a)]
    seen = []
    monkeypatch.setattr(dryrun, "_fan_out", lambda args, jobs, meshes: seen.append((jobs, meshes)) or 0)
    for i in (1, 2, 3):
        assert dryrun.main(["--all", "--mesh", "both", "--link-bw", "50e9", "--part", f"{i}/3"]) == 0
    assert len(want) == 36
    assert [j for jobs, _ in seen for j in jobs] == want[0::3] + want[1::3] + want[2::3]
    assert all(meshes == ["single", "multi"] for _, meshes in seen)
