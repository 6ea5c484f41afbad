"""The dry-run's variants (``benchmarks/perf_hillclimb.py``'s knobs) in the
port against the JAX package: for each of the hill-climb's 15 (cell,
variant) pairs on the production mesh, without running a step, the state
bytes against JAX's ``ShardingRules(..., zero_stage, model_axis,
fsdp_axes)`` specs over an ``AbstractMesh`` and the analytic terms against
JAX's ``cell_cost``; the records' names against JAX's ``run_cell``; reduced
cells under every variant on a fake (data 2, model 4) group; the tool's
``CELLS`` and ``VARIANTS`` against JAX's; and a cell that runs out of
memory, recorded ``ok: false`` and failing the CLI."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax

from benchmarks import perf_hillclimb as jax_hillclimb
from repro.analysis import analytic as jax_analytic
from repro.analysis.axis_attribution import classify_axis as jax_classify_axis
from repro.analysis import roofline as jax_roofline
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed.sharding import ShardingRules as JaxRules
from repro.launch import dryrun as jax_dryrun
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.analysis import analytic, roofline
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import build_model
from test_torch_dryrun import FakeMesh, _jax_bytes

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


def _jax_variant(name, arch):
    v = jax_hillclimb.VARIANTS[name]
    return dict(v[arch] if arch in v else v)


PAIRS = [(variant, arch, shape, mesh) for variant in sorted(jax_hillclimb.VARIANTS)
         for arch, shape, mesh in jax_hillclimb.CELLS]


def _jax_train_state(jcfg, mesh_shape, variant):
    """(state bytes, params) of a train cell as JAX's ``_lower_cell``
    counts them under ``variant`` (launch/dryrun.py:101-146)."""
    fsdp = variant.get("fsdp_axes")
    rules = JaxRules(jcfg, FakeMesh(mesh_shape), zero_stage=variant.get("zero_stage", 3),
                     model_axis=variant.get("model_axis", "model"), fsdp_axes=tuple(fsdp) if fsdp else None)
    params = jax.eval_shape(lambda: jax_build_model(jcfg).init(jax.random.key(0)))
    opt = jax.eval_shape(jax_adamw.init, params)
    return (2 * _jax_bytes(rules.params_specs(params), params, mesh_shape)
            + 2 * _jax_bytes(rules.opt_specs(params), opt.m, mesh_shape)), params


@pytest.mark.parametrize("variant,arch,shape_name,mesh_kind", PAIRS)
def test_variant_state_bytes_and_analytic_terms_equal_jax(variant, arch, shape_name, mesh_kind):
    """Each hill-climb pair on the production mesh, no step run: the
    port's state bytes from ``cell_rules`` equal JAX's specs' bytes, and
    its analytic terms at the variant's microbatches equal JAX's."""
    v = _jax_variant(variant, arch)
    mesh_shape = production_mesh_shape(mesh_kind == "multi")
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    shape = SHAPES[shape_name]
    state, cache = dryrun.cell_state_bytes(cfg, shape, dryrun.cell_rules(cfg, mesh_shape, v))
    want_state, jparams = _jax_train_state(jcfg, mesh_shape, v)
    assert (state, cache) == (want_state, 0.0)
    mb = dryrun.cell_microbatches(cfg, shape, v)
    assert mb == v.get("microbatches", jax_dryrun.MICROBATCHES.get(arch, 1))
    chips = 1
    for n in mesh_shape.values():
        chips *= n
    got = analytic.cell_cost(cfg, shape, roofline.matmul_param_count(build_model(cfg).init_shapes()),
                             cache_bytes=0.0, microbatches=mb)
    want = jax_analytic.cell_cost(jcfg, JAX_SHAPES[shape_name], jax_roofline.matmul_param_count(jparams),
                                  cache_bytes=0.0, microbatches=mb)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_zero1_shards_the_moments_and_replicates_the_parameters():
    """ZeRO-1's rules: the moments' specs are ZeRO-3's, the parameters'
    drop the fsdp axes; with no model axis the fsdp group is both axes."""
    cfg = get_arch("mixtral-8x7b")
    mesh = production_mesh_shape(False)
    shapes = build_model(cfg).init_shapes()
    z1 = dryrun.cell_rules(cfg, mesh, {"zero_stage": 1})
    z3 = dryrun.cell_rules(cfg, mesh, {})
    assert z1.opt_specs(shapes) == z3.params_specs(shapes)
    flat = lambda specs: {a for s in jax.tree.leaves(specs, is_leaf=lambda n: isinstance(n, tuple))
                          for e in s if e for a in (e if isinstance(e, tuple) else (e,))}
    assert flat(z1.params_specs(shapes)) == {"model"}
    none = dryrun.cell_rules(get_arch("rwkv6-3b"), mesh, _jax_variant("opt4", "rwkv6-3b"))
    assert (none.fsdp, none.model) == (("data", "model"), None)


@pytest.mark.parametrize("variant,arch", [(v, a) for v, a, _, _ in PAIRS])
def test_record_names_follow_jax(tmp_path, monkeypatch, variant, arch):
    """The port's ``run_cell`` and JAX's read the same file for a variant:
    a record at the port's path is what JAX's ``run_cell`` (pointed at the
    same folder, not forced) returns, and the port's returns it too."""
    v = _jax_variant(variant, arch)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(jax_dryrun, "RESULTS_DIR", tmp_path)
    path = dryrun.record_path(arch, "train_4k", "single", v)
    assert path.parent == tmp_path and path.name == f"{arch}__train_4k__single__{v['tag']}.json"
    path.write_text(json.dumps({"variant": v, "sentinel": variant}))
    assert jax_dryrun.run_cell(arch, "train_4k", "single", variant=dict(v))["sentinel"] == variant
    assert dryrun.run_cell(arch, "train_4k", "single", link_bw=50e9, variant=dict(v))["sentinel"] == variant
    assert dryrun.record_path(arch, "train_4k", "single").name == f"{arch}__train_4k__single.json"


def test_tool_cells_and_variants_equal_jax():
    """``tools/perf_hillclimb.py`` runs the package's ``HILLCLIMB_CELLS``
    and ``HILLCLIMB_VARIANTS``: JAX's, verbatim, and JAX's lookup."""
    assert dryrun.HILLCLIMB_CELLS == jax_hillclimb.CELLS
    assert dryrun.HILLCLIMB_VARIANTS == jax_hillclimb.VARIANTS
    for variant, arch, _, _ in PAIRS:
        assert dryrun.hillclimb_variant(variant, arch) == _jax_variant(variant, arch)


SEQ, BATCH = 16, 16
CALIBRATED = "opt4"  # ZeRO-1 with no model axis (rwkv6-3b), a microbatch cut (the others)
SWEEP_PROG = textwrap.dedent(
    """
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    seq, batch = int(sys.argv[1]), int(sys.argv[2])
    pairs = json.loads(sys.argv[3])
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    for arch, variant, calibrate in pairs:
        try:
            rec = dryrun.dryrun_cell(get_arch(arch).reduced(), ShapeConfig("train", seq, batch, "train"), mesh,
                                     mesh_kind="reduced", link_bw=50e9, device="cpu", variant=variant,
                                     skip_calibration=not calibrate)
        except Exception as e:  # recorded per cell; the test decides
            print(json.dumps({"arch": arch, "tag": variant["tag"], "error": f"{type(e).__name__}: {e}"}), flush=True)
            continue
        print(json.dumps({"arch": arch, "tag": variant["tag"], "record": rec}), flush=True)
    """
)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Every (cell, variant) pair of the hill-climb, at reduced widths, in
    one child process on a fake (data 2, model 4) group; the ``CALIBRATED``
    variant's cells with calibration (whose runs take the variant too)."""
    script = tmp_path_factory.mktemp("variants") / "sweep.py"
    script.write_text(SWEEP_PROG)
    pairs = [(arch, _jax_variant(variant, arch), variant == CALIBRATED) for variant, arch, _, _ in PAIRS]
    out = subprocess.run([sys.executable, str(script), str(SEQ), str(BATCH), json.dumps(pairs)],
                         capture_output=True, text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    return {(r["arch"], r["tag"]): r for r in rows}


@pytest.mark.parametrize("variant,arch", [(v, a) for v, a, _, _ in PAIRS])
def test_reduced_cell_under_each_variant_on_a_fake_two_by_four_mesh(sweep, variant, arch):
    """The reduced cell runs ``ok`` with the variant's state bytes (JAX's
    specs over the (2, 4) mesh, as built), JAX's analytic terms at the
    variant's microbatches and the variant in its record.  Under ZeRO-1
    no parameter is gathered; with no model axis the step runs on one
    mesh dimension of 8 ranks and traces nothing over "model"."""
    v = _jax_variant(variant, arch)
    row = sweep[(arch, v["tag"])]
    assert "error" not in row, row["error"][-2000:]
    rec = row["record"]
    mesh_shape = {"data": 2, "model": 4}
    jcfg = jax_get_arch(arch).reduced()
    want_state, jparams = _jax_train_state(jcfg, mesh_shape, v)
    assert rec["ok"] is True, rec["checks"]
    assert rec["bytes_per_device"] == want_state
    assert rec["memory_analysis"]["shard_bytes_allocated"] == want_state
    assert rec["variant"] == v
    mb = v.get("microbatches", jax_dryrun.MICROBATCHES.get(jcfg.name, 1))
    cost = jax_analytic.cell_cost(jcfg, JaxShape("train", SEQ, BATCH, "train"),
                                  jax_roofline.matmul_param_count(jparams), cache_bytes=0.0, microbatches=mb)
    assert (rec["hlo_flops"], rec["hlo_bytes"]) == (cost.flops_compiled / 8, cost.bytes_hbm / 8)
    assert rec["notes"].startswith(f"microbatches={mb};")
    calibration = "bilinear calibration" if variant == CALIBRATED else "production-run counts"
    assert rec["notes"].split("collectives: ")[1].startswith(calibration)
    assert rec["collective_bytes"] > 0 and rec["flop_counter"]["flops"] > 0
    if v.get("zero_stage") == 1:
        assert rec["param_gathers"] == 0
    axes = set(rec["per_axis_collectives"]) | set(rec["production_per_axis_collectives"])
    if v.get("model_axis") == "none":
        # the name JAX's classify_axis gives the replica group of all 8 ranks
        assert axes == {jax_classify_axis(8, 1, mesh_shape)} == {"data+model"}, axes
    else:
        assert "model" in axes


OOM_PROG = textwrap.dedent(
    """
    import sys
    from pathlib import Path
    import torch
    from repro_torch.launch import dryrun

    def out_of_memory(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.20 GiB.")

    dryrun.RESULTS_DIR = Path(sys.argv[1])
    dryrun._run_cell = out_of_memory
    sys.exit(dryrun.main(["--arch", "granite-3-8b", "--shape", "train_4k", "--link-bw", "50e9",
                          "--device", "cpu", "--force"]))
    """
)


def test_a_cell_that_runs_out_of_memory_is_recorded_and_fails_the_cli(tmp_path):
    """``_run_cell`` raising ``torch.OutOfMemoryError``: the CLI writes the
    record ``ok: false`` with the error's words, the specs' state bytes and
    the analytic terms, no collective figures, and exits non-zero."""
    script = tmp_path / "oom.py"
    script.write_text(OOM_PROG)
    out = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 1, out.stderr[-4000:]
    assert "[FAIL] granite-3-8b x train_4k x single" in out.stdout
    rec = json.loads((tmp_path / "granite-3-8b__train_4k__single.json").read_text())
    assert rec["ok"] is False
    assert rec["checks"] == ["out of memory: CUDA out of memory. Tried to allocate 1.20 GiB."]
    assert rec["out_of_memory"]["error"] == "CUDA out of memory. Tried to allocate 1.20 GiB."
    cfg, shape = get_arch("granite-3-8b"), SHAPES["train_4k"]
    rules = dryrun.cell_rules(cfg, production_mesh_shape(False))
    assert rec["bytes_per_device"] == dryrun.cell_state_bytes(cfg, shape, rules)[0]
    assert rec["memory_analysis"]["state_bytes"] == rec["bytes_per_device"]
    cost = analytic.cell_cost(cfg, shape, roofline.matmul_param_count(build_model(cfg).init_shapes()),
                              cache_bytes=0.0, microbatches=dryrun.MICROBATCHES["granite-3-8b"])
    assert rec["hlo_flops"] == cost.flops_compiled / 256 and rec["compute_term"] > 0
    for key in ("collective_bytes", "collective_term", "bottleneck", "per_axis_collectives"):
        assert rec[key] is None, key


def test_a_non_memory_error_propagates(monkeypatch):
    """Only an out-of-memory error becomes a record: any other exception
    of the run propagates out of ``dryrun_cell``."""
    from types import SimpleNamespace

    def broken(*args, **kwargs):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(dryrun, "_run_cell", broken)
    monkeypatch.setattr(dryrun, "run_mesh", lambda mesh, rules: None)
    mesh = SimpleNamespace(size=lambda: 8, shape=(2, 4), mesh_dim_names=("data", "model"))
    with pytest.raises(RuntimeError, match="not a memory error"):
        dryrun.dryrun_cell(get_arch("granite-3-8b").reduced(), SHAPES["train_4k"], mesh, mesh_kind="x",
                           link_bw=50e9, device="cpu")


def _record(arch, tag=None, ok=True):
    variant = {"tag": tag, "zero_stage": 1} if tag else {}
    axes = {"data": {"bytes": 1e9, "count": 3}}
    return {"arch": arch, "shape": "train_4k", "mesh": "single", "variant": variant, "compute_term": 1.0,
            "memory_term": 0.5, "collective_term": 2.0 if tag else 3.0, "bottleneck": "collective",
            "per_axis_collectives": axes, "view_replications": {}, "lower_seconds": 10.0,
            "compile_seconds": 5.0, "bytes_per_device": 123.0, "ok": ok,
            "memory_analysis": {"peak_allocated_bytes": 456}, "wall_seconds": 20.0}


def test_matrix_keeps_a_variant_apart_from_its_baseline(tmp_path):
    """``tools/dryrun_matrix.py`` keys records by their tag as well: a
    variant's record does not overwrite its cell's baseline row, the
    matrix leaves it out (JAX's ``load_records``), and ``variant_table``
    renders it with its knobs."""
    spec = importlib.util.spec_from_file_location("dryrun_matrix_tool", REPO / "tools" / "dryrun_matrix.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    base, var = tmp_path / "a__train_4k__single.json", tmp_path / "a__train_4k__single__opt2.json"
    base.write_text(json.dumps(_record("a")))
    var.write_text(json.dumps(_record("a", "opt2")))
    matrix = tool.table([base, var])
    assert "| a x train_4k | 1 / 0.5 / 3, collective // - |" in matrix and "/ 2," not in matrix
    variants = tool.variant_table([base, var])
    assert "| a x train_4k x single | opt2: zero_stage 1 | 1 / 0.5 / 2, collective |" in variants
    assert variants.count("\n| a x") == 1


CALIBRATION_OOM_PROG = textwrap.dedent(
    """
    import json
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    def out_of_memory(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.50 GiB.")

    dryrun._calibrate = out_of_memory
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    rec = dryrun.dryrun_cell(get_arch("granite-3-8b").reduced(), ShapeConfig("train", 16, 4, "train"), mesh,
                             mesh_kind="reduced", link_bw=50e9, device="cpu", variant={"microbatches": 2})
    print(json.dumps(rec))
    """
)


def test_a_calibration_that_runs_out_of_memory_leaves_the_production_counts(tmp_path):
    """A calibration run at one microbatch holds more rows than the cell's
    own: when it runs out of memory the cell is still ``ok``, with the
    production run's collectives (every layer traced) and the error in its
    notes and ``calibration_out_of_memory``."""
    script = tmp_path / "calibration_oom.py"
    script.write_text(CALIBRATION_OOM_PROG)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["ok"] is True
    assert rec["calibration_out_of_memory"] == "CUDA out of memory. Tried to allocate 4.50 GiB."
    assert rec["notes"] == ("microbatches=2; collectives: production-run counts (every layer traced); "
                            "the calibration ran out of memory: CUDA out of memory. Tried to allocate 4.50 GiB.")
    assert rec["collectives"] == rec["production_collectives"]
    assert rec["per_axis_collectives"] == rec["production_per_axis_collectives"]
