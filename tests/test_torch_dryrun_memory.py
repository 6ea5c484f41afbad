"""What one rank holds in the dry-run's train step, at reduced widths on a
fake (data 2, model 4) process group in one child process: every DTensor an
op takes (as ``Zero3Views`` hands it over) or makes is recorded with its
global and local shapes.

* No rank holds logits, or their gradient, over the whole vocabulary: the
  CE is vocabulary-parallel (``models.model._token_ce_on_shards``), so no
  (batch, sequence, ..., vocabulary) DTensor has a local dimension of the
  padded vocabulary (256; the model dimension shards it to 64).  Left to
  DTensor's rules, the card's torch made the CE's gradient whole on each
  rank (67 GB on command-r-35b).  (The head's weight gradient, a (256, 64)
  partial sum over both mesh dimensions, is still whole on each rank.)
* No rank holds more of a stacked parameter than its shard: each layer's
  weights are gathered where they are used and its gradients reduced as
  soon as they are made (``models.transformer.on_layer``), so no DTensor
  of a stacked leaf's shape is larger locally than the leaf's shard (the
  whole stack's partial gradient was 62 GB on nemotron-4-340b).
* The residual stream's gradient stays batch-sharded: no view replicates
  a sequence-sharded gradient (``models.transformer.residual``)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["command-r-35b", "granite-3-8b", "mixtral-8x7b", "nemotron-4-340b", "rwkv6-3b", "zamba2-2.7b"]
VOCAB = 256  # the reduced configs' padded vocabulary
# the views that still replicate in these train cells, none of them the
# residual stream's gradient: mixtral's router logits' gradient (4 = 2
# layers x 2 microbatches), zamba2's in_proj split
# (tests/test_torch_dryrun_reduced.py::SCAN_ARCH_REPLICATIONS)
REPLICATIONS = {"mixtral-8x7b": {"view@model": 4}, "zamba2-2.7b": {"view@model": 8}}

PROG = textwrap.dedent(
    """
    import json, math, sys
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import ShardingRules, mesh_axis_sizes, shard_shape
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model

    SEEN = []

    class Recorded:
        # func, recording the DTensors it takes (as Zero3Views hands them
        # over: gathered, laid out) and makes

        def __init__(self, func):
            self.func, self._opname, self.is_view = func, func._opname, func.is_view

        def __call__(self, *args, **kwargs):
            out = self.func(*args, **kwargs)
            for t in tree.leaves([list(args), out]):
                if isinstance(t, DTensor):
                    SEEN.append((self._opname, tuple(t.shape), tuple(t.to_local().shape)))
            return out

    class RecordingViews(dryrun.Zero3Views):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return super().__torch_dispatch__(Recorded(func), types, args, kwargs)

    dryrun.Zero3Views = RecordingViews
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    sizes = mesh_axis_sizes(mesh)
    for name in sys.argv[1].split(","):
        cfg = get_arch(name).reduced()
        rules = ShardingRules(cfg, sizes)
        shapes = build_model(cfg).init_shapes()
        specs = tree.leaves(rules.params_specs(shapes), is_leaf=lambda n: isinstance(n, tuple))
        stacked = {tuple(t.shape): math.prod(shard_shape(s, t.shape, sizes))
                   for (path, t), s in zip(tree.leaves_with_path(shapes), specs)
                   if any(k in ("layers", "mamba_layers") for k in map(str, path))}
        SEEN.clear()
        run = dryrun._run_cell(cfg, ShapeConfig("train", 16, 4, "train"), mesh, dryrun.run_mesh(mesh, rules),
                               microbatches=2, device="cpu")
        whole_vocab = sorted({f"{op} {g} -> {l}" for op, g, l in SEEN if len(l) >= 3 and int(sys.argv[2]) in l})
        over_shard = sorted({f"{op} {g} -> {l}" for op, g, l in SEEN if g in stacked and math.prod(l) > stacked[g]})
        print(json.dumps({"arch": name, "whole_vocab": whole_vocab, "over_shard": over_shard, "seen": len(SEEN),
                          "stacked": len(stacked), "replications": run.view_replications}), flush=True)
    """
)


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    script = tmp_path_factory.mktemp("held") / "held.py"
    script.write_text(PROG)
    out = subprocess.run([sys.executable, str(script), ",".join(ARCHS), str(VOCAB)], capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    return {r["arch"]: r for r in rows}


@pytest.mark.parametrize("name", ARCHS)
def test_no_rank_holds_logits_over_the_whole_vocabulary(held, name):
    assert held[name]["seen"] > 1000
    assert held[name]["whole_vocab"] == []


@pytest.mark.parametrize("name", ARCHS)
def test_no_rank_holds_more_of_a_stacked_parameter_than_its_shard(held, name):
    assert held[name]["stacked"] > 0
    assert held[name]["over_shard"] == []


@pytest.mark.parametrize("name", ARCHS)
def test_residual_gradients_stay_batch_sharded(held, name):
    assert held[name]["replications"] == REPLICATIONS.get(name, {})
