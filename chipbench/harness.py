"""The benchmark's harness: finds a cell's files by name, makes its inputs
from the seed, runs the cell's entry and assembles the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives:

* ``chipbench/configs/<config>.json`` (the ``file`` of the config entry):
  the model's sizes as run, in the program's field names, with its source,
  what was changed, what was assumed, which reference family computes it
  and which file counts its operations;
* ``chipbench/traffic/<mix>.json``: the entry that drives the mix
  (``chipbench/entries/<entry>.py``) and its parameters;
* ``chipbench/limits/<cell>.json``: each compared number's limit and the
  readings it was set from;
* ``chipbench/metrics/<metric>.py``: the reader of one per-layer metric;
* ``chipbench/reference/<family>.py``: the plain reference and the weights;
* ``chipbench/counts/<counts>.py``: the family's model operations.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import sys
import time
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(workload: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files read."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    limits_file = HERE / "limits" / f"{workload}.json"
    return Cell(
        name=workload, config_name=w["config"], traffic_name=w["traffic"], chips=w["chips"],
        cfg=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits_file.read_text())["limits"],
        end_to_end=e2e, per_layer=per_layer,
    )


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` from a configuration file: its fields
    are the file's keys of the same names, a nested group (``moe``, ``ssm``,
    ``rwkv``, ...) built as the dataclass its field is typed with."""
    from repro_torch.configs.base import ArchConfig

    hints = typing.get_type_hints(ArchConfig)
    kw = {}
    for f in dataclasses.fields(ArchConfig):
        if f.name not in cfg:
            continue
        value = cfg[f.name]
        if isinstance(value, dict):
            cls = next(t for t in typing.get_args(hints[f.name]) or (hints[f.name],) if dataclasses.is_dataclass(t))
            value = cls(**value)
        kw[f.name] = value
    return ArchConfig(**kw)


def family(cfg: dict):
    """The reference family module named by the configuration."""
    return importlib.import_module(f"chipbench.reference.{cfg['reference']}")


def entry(traffic: dict):
    return importlib.import_module(f"chipbench.entries.{traffic['entry']}")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (weights, prompts, sample)."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def token_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """Every batch the run can send: (pool, rows, length) token ids drawn
    uniformly from the vocabulary, in one call from the seed."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "tokens"))
    shape = (traffic["pool_batches"], traffic["rows"], traffic["length"])
    return torch.randint(0, cfg["vocab_size"], shape, generator=gen, device=device)


def load_reader(name: str):
    """The reader module of per-layer metric ``name`` (its file's name is
    the metric's, dots and all)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def free(device: torch.device) -> None:
    """Release what was freed on the card, so the next phase's peak is its own."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def forbidden_loaded() -> List[str]:
    """Modules whose top-level name is the JAX stack's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Outcome:
    """What an entry returns."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, float]  # each compared number's reading
    memory_peak_bytes: int
    units: int = 0  # batches or steps completed in the window
    trace: object = None  # chipbench.trace.Trace of a traced run
    notes: Dict[str, object] = field(default_factory=dict)


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # the host clock at the start of the process

    def setup_done(self) -> float:
        return time.perf_counter() - self.t0


def judge(cell: Cell, checks: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit."""
    out = {}
    for name, lim in cell.limits.items():
        value = checks.get(name)
        out[name] = {"value": value, "limit": lim["limit"],
                     "ok": value is not None and value == value and value <= lim["limit"]}
    return out


def per_layer_values(cell: Cell, out: Outcome, kind: str) -> Dict[str, dict]:
    from chipbench.peaks import peaks

    if out.trace is None:
        return {}
    run = TracedRun(cell=cell, units=out.units, trace=out.trace, peaks=peaks(kind))
    values = {}
    for m in cell.per_layer:
        v = load_reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    return values


@dataclass
class TracedRun:
    """What a per-layer metric's reader reads: the cell, the work completed
    in the traced window, the trace and the card's peaks (None if unknown)."""
    cell: Cell
    units: int
    trace: object
    peaks: Optional[dict]


def run_cell(workload, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float, root: Path = ROOT) -> dict:
    """Run one cell (a :class:`Cell` or its name) and return the result line
    (as a dict, keys in order)."""
    cell = workload if isinstance(workload, Cell) else resolve(workload, root)
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, t0=t0)
    out = entry(cell.traffic).run(ctx)
    verdict = judge(cell, out.checks)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if trace:
        metrics = per_layer_values(cell, out, kind)
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.failed == 0 and all(v["ok"] for v in verdict.values()), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"], dev["window_s"] = out.trace.busy_s, out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in verdict.items()}
    print(f"chipbench: {cell.name} seed {seed} " + json.dumps(out.notes), file=sys.stderr)
    return line
