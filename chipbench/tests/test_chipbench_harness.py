"""CPU tests of the benchmark's harness: every cell resolves to its files,
the counts equal hand-worked values, the result line has the contract's
keys, the trace reduces as it should, and nothing under chipbench/ imports
the JAX stack or the JAX package."""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from chipbench import flops, harness, trace
from chipbench.tests.cells import small_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_file_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"] and BENCH["command"][1].startswith("chipbench/")
    assert 10 <= BENCH["run_seconds"] <= 51
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in BENCH[group]:
            assert set(entry) == keys, entry
            assert NAME.match(entry["name"]) and len(entry["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in names and set(m["workloads"]) <= set(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    cell = harness.resolve(workload)
    assert (ROOT / "chipbench" / "reference" / f"{cell.cfg['reference']}.py").is_file()
    assert (ROOT / "chipbench" / "entries" / f"{cell.traffic['entry']}.py").is_file()
    assert (ROOT / "chipbench" / "counts" / f"{cell.cfg['counts']}.py").is_file()
    assert cell.limits, "each cell has its limits"
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
        assert m["moves"] in reported


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_repository_config(config):
    """The file's sizes are the port's registered config's, but for the keys
    it lists in ``reduced``."""
    from repro_torch.configs import get_arch

    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
    ours = harness.arch_config(cfg)
    theirs = get_arch(config.removesuffix("-pp5"))
    for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                  "resolved_head_dim", "mlp_act", "tied_embeddings", "rope_theta", "ssm",
                  "shared_attn_every", "param_dtype", "activation_dtype", "sliding_window", "moe"):
        if field in cfg["reduced"]:
            assert getattr(ours, field) != getattr(theirs, field)
        else:
            assert getattr(ours, field) == getattr(theirs, field), field


@pytest.mark.parametrize("arch", ["granite-3-8b", "mixtral-8x7b", "zamba2-2.7b", "rwkv6-3b"])
def test_arch_config_builds_every_nested_group(arch):
    """A configuration file of any family, nested groups and all, gives the
    program's config: a new family needs no edit of the harness."""
    from repro_torch.configs import get_arch

    want = get_arch(arch)
    cfg = json.loads(json.dumps(dataclasses.asdict(want)))  # as a file holds it
    assert harness.arch_config(cfg) == want


def test_granite_flops_by_hand():
    """granite-3-8b at 4 x 4096: matrices 40 x (4096 x 128 x 80 + 3 x 4096 x
    12800) = 7.97e9; attention 4 x 128 x 32 x 4096 x 4097 / 2 a layer and
    row; the head at one position a row."""
    cfg = harness.resolve("granite-3-8b.score-4k").cfg
    matrices = 40 * (4096 * 128 * 80 + 3 * 4096 * 12800)
    attn = 40 * 4 * 128 * 32 * (4096 * 4097 // 2) * 4
    want = 2 * matrices * 4 * 4096 + attn + 2 * 4096 * 49155 * 4
    assert flops.score_flops(cfg, 4, 4096) == want
    train = harness.resolve("granite-3-8b-pp5.train-4k").cfg
    fwd = 2 * 8 * (4096 * 128 * 80 + 3 * 4096 * 12800) * 8 * 4096 + 8 * 16384 * (4096 * 4097 // 2) * 8 \
        + 2 * 4096 * 49155 * 4096 * 8
    assert flops.train_flops(train, 8, 4096) == 3 * fwd


def test_flash_work_and_bound_by_hand():
    nbytes, ops = flops.flash_work(1, 4, 2, 1, 8, 2)
    assert nbytes == 2 * 4 * 8 * 6 and ops == 4 * 8 * 2 * 10
    assert flops.bound_s(100.0, 1000.0, 10.0, 1.0) == 100.0
    assert flops.bound_s(10.0, 1000.0, 10.0, 1.0) == 100.0


def _event(name, kind, start, dur):
    """An event of activity type ``kind`` as torch gives it: its device and
    its annotation flag, no activity type."""
    cuda = kind in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                           is_user_annotation=lambda: kind.endswith("user_annotation"),
                           start_ns=lambda: start, duration_ns=lambda: dur)


def test_trace_reduction_busy_gaps_and_names():
    us = 1000
    events = [
        _event(trace.WINDOW, "user_annotation", 0, 1000 * us),
        _event("gemm_kernel", "kernel", 100 * us, 300 * us),
        _event("gemm_kernel", "kernel", 350 * us, 100 * us),  # overlaps: the union counts once
        _event("void (anonymous namespace)::flash_fwd_sm90_kernel<128>(CUtensorMap, int)", "kernel", 600 * us, 200 * us),
        _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 995 * us, 10 * us),  # clipped at the end
        _event(trace.WINDOW, "gpu_user_annotation", 0, 1000 * us),  # never busy time
        _event("aten::embedding", "cpu_op", 0, 90 * us),
        _event("cudaLaunchKernel", "cuda_runtime", 40 * us, 20 * us),
        _event("aten::item", "cpu_op", 450 * us, 160 * us),
        _event("cudaStreamSynchronize", "cuda_runtime", 455 * us, 150 * us),
    ]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((350 + 200 + 5) * 1e-6)
    assert t.seconds_of(["flash_fwd_sm90_kernel"]) == pytest.approx(200e-6)
    assert t.gaps == pytest.approx({"host: aten::embedding": 100e-6, "host: aten::item": 150e-6,
                                    "host: none": 195e-6})
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemm_kernel", pytest.approx(400e-6)]  # summed by name
    assert ["flash_fwd_sm90_kernel<128>", pytest.approx(200e-6)] in b["device_ops"]
    assert ["Memcpy DtoH", pytest.approx(5e-6)] in b["device_ops"]
    assert [trace.kind_of(e) for e in events] == ["user_annotation", "kernel", "kernel", "kernel", "gpu_memcpy",
                                                  "gpu_user_annotation", "cpu_op", "cuda_runtime", "cpu_op",
                                                  "cuda_runtime"]
    # a gap in which only a runtime call is open is named by it
    t = trace.reduce([_event(trace.WINDOW, "user_annotation", 0, 1000 * us), _event("k", "kernel", 0, 500 * us),
                      _event(trace.WINDOW, "gpu_user_annotation", 0, 1000 * us),
                      _event("cudaMalloc", "cuda_runtime", 600 * us, 300 * us)])
    assert t.busy_s == pytest.approx(500e-6) and t.gaps == pytest.approx({"host: cudaMalloc": 500e-6})


@pytest.mark.parametrize("workload,traced", [("granite-3-8b.score-4k", False), ("granite-3-8b.score-4k", True),
                                             ("granite-3-8b.score-512", False),
                                             ("granite-3-8b-pp5.train-4k", False),
                                             ("granite-3-8b-pp5.train-4k", True)])
def test_result_line_has_the_contract_keys(workload, traced):
    line = harness.run_cell(small_cell(workload), 2**33 + 7, 0.2, traced, torch.device("cpu"), time.perf_counter())
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = harness.resolve(workload)
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    else:  # no device on the CPU: the device's readers find nothing to read
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(cell.limits)
    json.dumps(line)


def test_same_seed_same_inputs():
    cell = small_cell("granite-3-8b.score-4k")
    fam = harness.family(cell.cfg)
    a, b = (fam.init_weights(cell.cfg, harness.subseed(2**40 + 3, "weights"), "cpu") for _ in range(2))
    assert torch.equal(a["layers"]["mlp"]["wi"], b["layers"]["mlp"]["wi"])
    p, q = (harness.token_pool(cell.cfg, cell.traffic, 2**40 + 3, "cpu") for _ in range(2))
    assert torch.equal(p, q) and not torch.equal(p[0], p[1])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_the_jax_stack_or_package():
    files = sorted((ROOT / "chipbench").rglob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "chipbench" / "reference").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert tops <= {"__future__", "math", "typing", "torch"}, (f, tops)


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chipbench" / "run.py"), "--workload", CELLS[0],
                          "--seed", str(2**32 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
