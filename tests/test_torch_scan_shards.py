"""The SSD and WKV scans on their shards compute what the plain scans compute.

Reduced zamba2-2.7b (8 SSD heads) and rwkv6-3b (4 WKV heads), float32, run
on 4 spawned gloo ranks, a real (data 2, model 2) mesh whose model
dimension divides the heads: parameters, moments, batch and caches as
DTensors of their ``ShardingRules`` placements, under the dry-run's
``Zero3Views`` and ``implicit_replication``, so each scan runs through
``models.layers.scan_on_shards`` on its batch and head shards.  Held
against the plain single-process model on the same parameters (JAX's
init, converted) at rtol 1e-5, atol 1e-6: one microbatch's loss, every
gathered gradient and the global norm; the 2-microbatch train step's loss
and grad norm; a decode step's logits and every cache leaf (atol 1e-5:
the caches hold values of order 1), which the step writes in place with
its placements kept.  The train step's loss is also
held against ``jax.jit`` of the JAX package's train step at 2e-4.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.optim import adamw as jax_adamw
from repro.train import make_train_step as jax_make_train_step
from torch_parity import F32_TOL, assert_close, f32_pair, jax_setup, to_torch

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("zamba2-2.7b", "rwkv6-3b")
B, S, MICROBATCHES = 8, 16, 2
DECODE_LEN, POSITION = 16, 7
OPT = dict(lr=1e-2, warmup_steps=1)

STEP_PROG = textwrap.dedent(
    """
    import dataclasses, json, sys
    from pathlib import Path
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    N = 4
    RTOL, ATOL = 1e-5, 1e-6  # float32: the sharded reductions sum in another order
    DECODE_ATOL = 1e-5  # the decode caches hold values of order 1 summed over a sharded d_model

    def close(got, want, atol=ATOL):
        return bool(np.allclose(got.detach().double().numpy(), want.detach().double().numpy(),
                                rtol=RTOL, atol=atol))

    def rank_main(rank, port, workdir, archs):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=N)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch import tree
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import ShardingRules, mesh_axis_sizes, named, placements
        from repro_torch.launch.dryrun import Zero3Views, run_mesh
        from repro_torch.models.model import build_model
        from repro_torch.optim import adamw
        from repro_torch.train import steps

        workdir = Path(workdir)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        is_spec = lambda n: isinstance(n, tuple)
        rows = []
        for name in archs:
            cfg = dataclasses.replace(get_arch(name).reduced(), param_dtype="float32",
                                      activation_dtype="float32")
            rules = ShardingRules(cfg, mesh_axis_sizes(mesh))
            rmesh = run_mesh(mesh, rules)
            plain = build_model(cfg)
            sharded = dataclasses.replace(plain, logits_sharding=lambda nd: placements(rules.logits_spec(nd), rmesh))
            saved = torch.load(workdir / f"{name}.pt")
            params, batch, cache = saved["params"], saved["batch"], saved["cache"]
            spread = lambda t, spec: distribute_tensor(t.clone(), rmesh, placements(spec, rmesh))
            spread_tree = lambda t, specs: tree.unflatten(t, [spread(x, s) for x, s in zip(
                tree.leaves(t), tree.leaves(specs, is_leaf=is_spec), strict=True)])
            specs = rules.params_specs(params)
            dparams = spread_tree(params, specs)
            dbatch = spread_tree(batch, rules.batch_specs(batch))
            moments = lambda: spread_tree(tree.tree_map(torch.zeros_like, params), specs)
            dopt = adamw.AdamWState(torch.zeros((), dtype=torch.int32), moments(), moments())
            views = Zero3Views(dparams, fsdp_dim=0)
            checks = {}

            # one microbatch's loss, gradients and global norm
            want_loss, _, want_grads = steps._grads(plain, params, batch)
            with implicit_replication(), views:
                loss, _, grads = steps._grads(sharded, dparams, dbatch)
                grads = steps._constrain(grads, tree.leaves(named(rmesh, specs), is_leaf=is_spec))
                norm = adamw.global_norm(grads)
            checks["loss"] = close(loss.full_tensor(), want_loss)
            paths = [str(p) for p, _ in tree.leaves_with_path(params)]
            bad = [p for p, g, w in zip(paths, grads, want_grads, strict=True) if not close(g.full_tensor(), w)]
            checks["gradients"] = not bad or bad
            checks["global norm"] = close(norm, adamw.global_norm(want_grads))

            # a decode step on the head-sharded caches, written in place
            want_cache = tree.tree_map(lambda t: t.clone(), cache)
            token = {"tokens": saved["token"]}
            with torch.no_grad():
                want_logits, _ = plain.decode_step(params, want_cache, token, saved["position"])
            dcache = spread_tree(cache, rules.cache_specs(cache))
            before = [(t.placements, t.to_local().data_ptr()) for t in tree.leaves(dcache)]
            dtoken = spread_tree(token, rules.batch_specs(token))
            with torch.no_grad(), implicit_replication(), views:
                logits, out_cache = sharded.decode_step(dparams, dcache, dtoken, saved["position"])
            full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
            checks["decode logits"] = close(full(logits), want_logits, DECODE_ATOL)
            cpaths = [str(p) for p, _ in tree.leaves_with_path(cache)]
            bad = [p for p, g, w in zip(cpaths, tree.leaves(out_cache), tree.leaves(want_cache), strict=True)
                   if not close(g.full_tensor(), w, DECODE_ATOL)]
            checks["decode caches"] = not bad or bad
            after = [(t.placements, t.to_local().data_ptr()) for t in tree.leaves(out_cache)]
            checks["caches in place"] = after == before
            checks["heads sharded"] = [str(p) for p, t in zip(cpaths, tree.leaves(dcache))
                                       if p.endswith(("'ssm']", "'wkv']")) and not t.placements[1].is_shard()] or True
            # the whole step: microbatches, grad_placements, AdamW (last: it updates dparams)
            opt_cfg = adamw.AdamWConfig(**saved["opt"])
            ref = steps.make_train_step(plain, opt_cfg, microbatches=saved["microbatches"])(
                tree.tree_map(lambda t: t.clone(), params), adamw.init(params), batch)[2]
            step = steps.make_train_step(sharded, opt_cfg, microbatches=saved["microbatches"],
                                         grad_placements=named(rmesh, specs))
            with implicit_replication(), views:
                _, _, metrics = step(dparams, dopt, dbatch)
            checks["step loss"] = close(full(metrics["loss"]), ref["loss"])
            checks["step grad norm"] = close(full(metrics["grad_norm"]), ref["grad_norm"])
            step_loss = float(full(metrics["loss"]))

            rows.append({"arch": name, "checks": checks, "step_loss": step_loss})
        if rank == 0:
            (workdir / "result.json").write_text(json.dumps(rows))
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(int(sys.argv[1]), sys.argv[2], sys.argv[3].split(",")), nprocs=N, join=True)
    """
)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's parameters, a batch and seeded caches for each arch, the 4-rank
    run over them, and JAX's train-step loss on the same inputs."""
    workdir = tmp_path_factory.mktemp("scan_shards")
    jax_loss = {}
    for i, name in enumerate(ARCHS):
        jcfg, tcfg = f32_pair(name)
        jmodel, jparams, _ = jax_setup(jcfg, i, B, S)
        rng = np.random.default_rng(10 + i)
        tokens = rng.integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
        jstep = jax.jit(jax_make_train_step(jmodel, jax_adamw.AdamWConfig(**OPT), MICROBATCHES))
        _, _, jm = jstep(jparams, jax_adamw.init(jparams), {"tokens": jnp.asarray(tokens)})
        jax_loss[name] = jm["loss"]
        from repro_torch.models.model import build_model

        cache = build_model(tcfg).init_cache(B, DECODE_LEN, device="cpu")
        gen = torch.Generator().manual_seed(20 + i)
        cache = {k: torch.randn(v.shape, generator=gen).to(v.dtype) * 0.5 for k, v in cache.items()}
        torch.save({"params": to_torch(jparams), "batch": {"tokens": torch.from_numpy(tokens).long()},
                    "cache": cache, "position": POSITION, "opt": OPT, "microbatches": MICROBATCHES,
                    "token": torch.from_numpy(tokens[:, POSITION:POSITION + 1]).long()},
                   workdir / f"{name}.pt")
    script = workdir / "scan_shards.py"
    script.write_text(STEP_PROG)
    out = subprocess.run([sys.executable, str(script), str(_free_port()), str(workdir), ",".join(ARCHS)],
                         capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-6000:]
    rows = json.loads((workdir / "result.json").read_text())
    return {r["arch"]: r for r in rows}, jax_loss


TRAIN_CHECKS = ("loss", "gradients", "global norm", "step loss", "step grad norm")
DECODE_CHECKS = ("decode logits", "decode caches", "caches in place", "heads sharded")


@pytest.mark.parametrize("name", ARCHS)
def test_scan_train_step_on_shards_matches_the_plain_step(runs, name):
    """Loss, every gathered gradient, the global norm and the 2-microbatch
    step's loss and grad norm at rtol 1e-5, atol 1e-6."""
    checks = runs[0][name]["checks"]
    assert {k: checks[k] for k in TRAIN_CHECKS} == dict.fromkeys(TRAIN_CHECKS, True)


@pytest.mark.parametrize("name", ARCHS)
def test_scan_decode_step_on_shards_matches_the_plain_step(runs, name):
    """Logits and every cache leaf after one decode step at rtol 1e-5,
    atol 1e-5; the caches written in place with their placements, the SSD
    and WKV states sharded over heads on "model"."""
    checks = runs[0][name]["checks"]
    assert {k: checks[k] for k in DECODE_CHECKS} == dict.fromkeys(DECODE_CHECKS, True)


@pytest.mark.parametrize("name", ARCHS)
def test_scan_train_step_on_shards_matches_jax(runs, name):
    """The 4-rank step's loss against jax.jit of the JAX train step, 2e-4."""
    rows, jax_loss = runs
    assert_close(np.float32(rows[name]["step_loss"]), jax_loss[name], F32_TOL)
