"""Every arch's train (2 microbatches), prefill and decode cell through the
port's dry-run, at reduced widths on a fake (data 2, model 4) process group
in one child process: each cell, the MoE ones included (their dispatch
and combine run on each rank's batch shards), has the JAX specs' state
bytes and JAX's analytic terms."""

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
                                         microbatches=2 if kind == "train" else None)
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
