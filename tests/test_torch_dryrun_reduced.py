"""Every arch's train (2 microbatches), prefill and decode cell through the
port's dry-run, at reduced widths on a fake (data 2, model 4) process group
in one child process: each cell, the MoE ones included (their dispatch
and combine run on each rank's batch shards), has the JAX specs' state
bytes and JAX's analytic terms.  The SSD and WKV scans run on their batch
and head shards (4 divides the reduced 8 SSD and 4 WKV heads), so the
zamba2 and rwkv6 cells record only the view replications named in
``SCAN_ARCH_REPLICATIONS``, none of them the scans'."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShape
from test_torch_dryrun import _jax_cell_cost, _jax_state

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = {"data": 2, "model": 4}
SEQ, BATCH = 16, 4
KINDS = ("train", "prefill", "decode")

# What ``Zero3Views`` still replicates before a view in the zamba2 and
# rwkv6 cells on the fake (2, 4) mesh; the scans themselves
# (``models.layers.scan_on_shards``) replicate nothing.
SCAN_ARCH_REPLICATIONS = {
    # in_proj's output is sharded over "model" in 70-column blocks that the
    # z | x | B | C | dt boundaries do not follow, so its split replicates
    # it, as GSPMD reshards a split across its shards' boundaries; in the
    # backward the pieces' gradients concatenate sequence-sharded and the
    # view into in_proj's weight-gradient product replicates them: one per
    # Mamba2 layer (4) and microbatch (2)
    ("zamba2-2.7b", "train"): {"view@model": 8},
    ("zamba2-2.7b", "prefill"): {},
    # the shared attention block's decode (``attention_decode``'s einsums
    # merge a batch sharded over "data" with KV heads sharded over "model"),
    # not the SSD step
    ("zamba2-2.7b", "decode"): {"view@model": 2, "_unsafe_view@model": 4},
    ("rwkv6-3b", "train"): {},
    ("rwkv6-3b", "prefill"): {},
    ("rwkv6-3b", "decode"): {},
}

# The bytes and ops over "model" that each train cell traced when a
# product's other operand was replicated over "model" and the lookup took
# the whole table, DTensor choosing the rest (among it, gathers of weights
# over "model"): Megatron's layout must not move more.  A residual stream
# left partial over "model" (reduced again by every op that reads it)
# moves more on command-r, mixtral, nemotron and phi3.5-moe.
MODEL_AXIS_CEILING = {
    "command-r-35b": (597136.0, 170.0),
    "granite-3-8b": (1056656.0, 222.0),
    "internvl2-1b": (1273236.0, 235.0),
    "llama3-70b": (1048468.0, 223.0),
    "mixtral-8x7b": (657300.0, 179.0),
    "musicgen-large": (1007068.0, 201.0),
    "nemotron-4-340b": (686096.0, 226.0),
    "phi3.5-moe-42b-a6.6b": (657300.0, 179.0),
    "qwen1.5-110b": (1056152.0, 236.0),
    "rwkv6-3b": (1462556.0, 431.0),
    "zamba2-2.7b": (2809636.0, 597.0),
}
DENSE_ARCHS = ("command-r-35b", "granite-3-8b", "llama3-70b", "nemotron-4-340b", "qwen1.5-110b")

SWEEP_PROG = textwrap.dedent(
    """
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import all_archs, get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    seq, batch = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    for name in sorted(all_archs()):
        for kind in ("train", "prefill", "decode"):
            try:
                rec = dryrun.dryrun_cell(get_arch(name).reduced(), ShapeConfig(kind, seq, batch, kind), mesh,
                                         mesh_kind="reduced", link_bw=50e9, device="cpu",
                                         variant={"microbatches": 2} if kind == "train" else None)
            except Exception as e:  # recorded per cell; the test decides
                print(json.dumps({"arch": name, "kind": kind, "error": f"{type(e).__name__}: {e}"}), flush=True)
                continue
            print(json.dumps({"arch": name, "kind": kind, "record": rec}), flush=True)
    """
)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    script = tmp_path_factory.mktemp("sweep") / "sweep.py"
    script.write_text(SWEEP_PROG)
    out = subprocess.run([sys.executable, str(script), str(SEQ), str(BATCH)], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    return {(r["arch"], r["kind"]): r for r in rows}


@pytest.mark.parametrize("name,kind", [(n, k) for n in sorted(jax_all_archs()) for k in KINDS])
def test_reduced_cell_on_a_fake_two_by_four_mesh(sweep, name, kind):
    row = sweep[(name, kind)]
    assert "error" not in row, row["error"][-2000:]
    rec = row["record"]
    jcfg = jax_get_arch(name).reduced()
    shape = JaxShape(kind, SEQ, BATCH, kind)
    mb = 2 if kind == "train" else 1
    want_state, _, _ = _jax_state(jcfg, shape, MESH)
    assert rec["ok"] is True
    assert rec["bytes_per_device"] == want_state
    assert rec["memory_analysis"]["shard_bytes_allocated"] == want_state
    cost = _jax_cell_cost(jcfg, shape, MESH, mb)
    chips = MESH["data"] * MESH["model"]
    assert (rec["hlo_flops"], rec["hlo_bytes"]) == (cost.flops_compiled / chips, cost.bytes_hbm / chips)
    assert rec["flops_breakdown"] == cost.breakdown
    assert rec["collective_bytes"] > 0 and rec["flop_counter"]["flops"] > 0
    assert rec["variant"] == ({"microbatches": 2} if kind == "train" else {})


@pytest.mark.parametrize("name,kind", sorted(SCAN_ARCH_REPLICATIONS))
def test_scans_replicate_nothing_on_a_fake_two_by_four_mesh(sweep, name, kind):
    """The zamba2 and rwkv6 cells' view replications are exactly the ones
    ``SCAN_ARCH_REPLICATIONS`` names: a gather the scans (or their head
    split and merge) added would raise the count."""
    row = sweep[(name, kind)]
    assert "error" not in row, row["error"][-2000:]
    assert row["record"]["view_replications"] == SCAN_ARCH_REPLICATIONS[(name, kind)]


@pytest.mark.parametrize("name", sorted(MODEL_AXIS_CEILING))
def test_train_cell_moves_no_more_over_model_than_the_replicated_layout(sweep, name):
    """The production run of each train cell moves no more bytes, in no
    more ops, over "model" than ``MODEL_AXIS_CEILING`` holds."""
    row = sweep[(name, "train")]
    assert "error" not in row, row["error"][-2000:]
    got = row["record"]["production_per_axis_collectives"]["model"]
    bytes_, ops = MODEL_AXIS_CEILING[name]
    assert got["bytes"] <= bytes_ and got["count"] <= ops, got


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_dense_train_cell_reduces_over_model_as_megatron(sweep, name):
    """Over "model" a dense train cell moves only Megatron's reductions of
    a microbatch's activations (one row per rank at the sweep's size):
    per layer and microbatch at most six, the forward's two, the
    recompute's two and the backward's two, and per microbatch one for
    the lookup and one for the loss.  A residual stream left partial over
    "model" is reduced again by every op that reads it (about 30 a layer
    and microbatch)."""
    row = sweep[(name, "train")]
    assert "error" not in row, row["error"][-2000:]
    cfg = jax_get_arch(name).reduced()
    mb = 2
    activation = BATCH // MESH["data"] // mb * SEQ * cfg.d_model * 4  # float32
    got = row["record"]["production_per_axis_collectives"]["model"]["bytes"]
    assert got <= (6 * cfg.n_layers + 2) * mb * activation, got / activation
