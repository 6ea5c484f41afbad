"""Block remat in the dry-run keeps each layer's input as this rank's slice
of its sequence over "model" (``models.transformer._SequenceSlice``).

Reduced train cells (2 microbatches) run rank 0's step on a fake (data 2,
model 4) process group in one child process, once as the port runs them and
once with the slice turned off (``_model_dim`` returning None: torch's
checkpoint alone, which keeps the whole input):

* each layer's input is kept at 1/4 of the local bytes of its replica, one
  slice per layer and microbatch;
* the whole input is freed once the layer's forward pass is done: no input
  a layer read is alive after the model's forward pass (torch's
  checkpoint, holding its arguments, keeps every one);
* the only traffic added is one all-gather over "model" of a layer input
  per layer and microbatch (its local replica's bytes), and every other
  collective of the step is the same op for op.

The values are held against the plain step on 4 gloo ranks by
``tests/test_torch_dtensor_step.py`` (dense) and
``tests/test_torch_scan_shards.py`` (zamba2, rwkv6), whose (2, 2) mesh
takes the same path."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
# dense, parallel block, MoE (aux outputs), the hybrid and the RWKV family
ARCHS = ["granite-3-8b", "command-r-35b", "mixtral-8x7b", "zamba2-2.7b", "rwkv6-3b"]
MB = 2

PROG = textwrap.dedent(
    """
    import collections, gc, json, sys, weakref
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import ShardingRules, mesh_axis_sizes
    from repro_torch.launch import dryrun
    from repro_torch.models import rwkv_lm, transformer, zamba

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    sizes = mesh_axis_sizes(mesh)
    CUTS, INPUTS, ALIVE = [], [], []

    cut = transformer._SequenceSlice.cut
    def recording_cut(self):
        INPUTS.append(weakref.ref(self.x._local_tensor))
        whole = self.x.to_local().nbytes
        cut(self)
        CUTS.append((whole, self.piece.to_local().nbytes, self.x is None))
    transformer._SequenceSlice.cut = recording_cut

    for mod in (transformer, zamba, rwkv_lm):
        def forward(*a, _f=mod.forward, **k):
            out = _f(*a, **k)
            gc.collect()
            ALIVE.append(sum(r() is not None for r in INPUTS))
            INPUTS.clear()
            return out
        mod.forward = forward

    model_dim = transformer._model_dim
    for name in sys.argv[1].split(","):
        row = {"arch": name}
        for mode in ("slice", "whole"):
            transformer._model_dim = model_dim if mode == "slice" else (lambda x: None)
            if mode == "whole":  # torch's checkpoint: record its inputs
                ckpt = transformer.torch.utils.checkpoint.checkpoint
                def recording(fn, *args, _c=ckpt, **kw):
                    INPUTS.append(weakref.ref(args[1]._local_tensor))
                    return _c(fn, *args, **kw)
                transformer.torch.utils.checkpoint.checkpoint = recording
            CUTS.clear(); ALIVE.clear()
            cfg = get_arch(name).reduced()
            rules = ShardingRules(cfg, sizes)
            run = dryrun._run_cell(cfg, ShapeConfig("train", 16, 4, "train"), mesh, dryrun.run_mesh(mesh, rules),
                                   microbatches=int(sys.argv[2]), device="cpu")
            if mode == "whole":
                transformer.torch.utils.checkpoint.checkpoint = ckpt
            ranks = {g: tuple(r) for g, r in zip(("data", "model"), (mesh["data"].mesh.tolist(),
                                                                    mesh["model"].mesh.tolist()))}
            ops = collections.Counter(
                f"{op.kind} {op.bytes} {'model' if tuple(op.group_ranks) == ranks['model'] else 'other'}"
                for op in run.trace.ops)
            row[mode] = {"cuts": CUTS[:], "alive": ALIVE[:], "ops": dict(ops), "n_layers": cfg.n_layers}
        print(json.dumps(row), flush=True)
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    script = tmp_path_factory.mktemp("ckpt") / "ckpt.py"
    script.write_text(PROG)
    out = subprocess.run([sys.executable, str(script), ",".join(ARCHS), str(MB)], capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    return {r["arch"]: r for r in rows}


@pytest.mark.parametrize("name", ARCHS)
def test_each_layer_input_is_kept_at_a_quarter_of_its_local_bytes(runs, name):
    got = runs[name]["slice"]
    assert len(got["cuts"]) == got["n_layers"] * MB
    for whole, kept, dropped in got["cuts"]:
        assert kept * 4 == whole and dropped


@pytest.mark.parametrize("name", ARCHS)
def test_whole_layer_inputs_are_freed_after_the_forward_pass(runs, name):
    assert runs[name]["slice"]["alive"] == [0] * MB
    # torch's checkpoint holds its arguments: every input is still alive
    whole = runs[name]["whole"]
    assert whole["alive"] == [whole["n_layers"]] * MB


@pytest.mark.parametrize("name", ARCHS)
def test_the_only_added_traffic_is_one_gather_per_layer_and_microbatch(runs, name):
    got, whole = runs[name]["slice"], runs[name]["whole"]
    added = {k: got["ops"].get(k, 0) - whole["ops"].get(k, 0) for k in set(got["ops"]) | set(whole["ops"])}
    added = {k: v for k, v in added.items() if v}
    local_bytes = got["cuts"][0][0]
    assert added == {f"all-gather {local_bytes} model": got["n_layers"] * MB}
