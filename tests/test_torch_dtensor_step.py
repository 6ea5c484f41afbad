"""The dry-run's DTensor train step computes what the plain step computes.

Reduced granite (float32) runs its train step on 4 spawned gloo ranks, a
real (data 2, model 2) mesh where the collectives move data: parameters,
moments and batch as DTensors of their ``ShardingRules`` placements, under
the dry-run's ``Zero3Views`` and ``implicit_replication``, with the
vocabulary-sharded logits, 2 microbatches cut per shard, ``grad_placements``
and the AdamW update on local shards with the all-reduced global norm.  The
loss, the gathered gradients, the global norm and the moments are held
against the plain single-process step on the same seed, and the updated
parameters against the plain update of the step's gradients, at float32
tolerance.  A wrong placement (a Replicate in place of a
Partial gradient, a norm not reduced over a shard) changes these numbers.

The same program runs the dry-run's variants (JAX's ``perf_hillclimb``
knobs) against the plain block-remat, unchunked step at 2e-4 + 2e-4 |want|:
ZeRO-1 on (data 2, model 2), whose update all-gathers each parameter its
moments shard; ZeRO-1 with no model axis, 4-way fsdp over "data+model";
``loss_chunk``; and ``remat="dots"``.
"""

import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

STEP_PROG = textwrap.dedent(
    """
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    N = 4
    RTOL, ATOL = 1e-5, 1e-6  # float32: the sharded reductions sum in another order

    def close(name, got, want, rtol=RTOL, atol=ATOL):
        np.testing.assert_allclose(got.detach().double().numpy(), want.detach().double().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)

    def plain_update(opt_cfg, params, got_m):
        # The plain update of the (clipped) gradients a step's first moments
        # hold: Adam's first step divides each gradient by its magnitude, so
        # a gradient near 0 that differs in its last bits moves its
        # parameter by up to lr.
        from repro_torch import tree
        from repro_torch.optim import adamw
        used = tree.unflatten(params, [m / (1 - opt_cfg.beta1) for m in got_m])
        want = tree.tree_map(lambda t: t.clone(), params)
        want, _, _ = adamw.update(dataclasses.replace(opt_cfg, clip_norm=None), used, adamw.init(want), want)
        return want

    def variant_step(label, mesh, cfg, variant, opt_cfg, batch):
        # The plain block-remat, unchunked step against the variant's
        # DTensor step: one microbatch's loss and gradients, then the whole
        # step at 2 microbatches (loss, moments, parameters); under ZeRO-1
        # the update all-gathers each parameter whose moments it shards.
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch import tree
        from repro_torch.analysis.roofline import CollectiveTrace
        from repro_torch.distributed.sharding import named, placements
        from repro_torch.launch.dryrun import Zero3Views, cell_model, cell_rules, run_mesh
        from repro_torch.models.model import build_model
        from repro_torch.optim import adamw
        from repro_torch.train import steps

        tol = dict(rtol=2e-4, atol=2e-4)
        rules = cell_rules(cfg, mesh, variant)
        rmesh = run_mesh(mesh, rules)
        plain = build_model(cfg)
        sharded = cell_model(cfg, variant, logits_sharding=lambda nd: placements(rules.logits_spec(nd), rmesh))
        params = plain.init(0, device="cpu")
        specs = rules.params_specs(params)
        leaves_of = lambda t: tree.leaves(t, is_leaf=lambda n: isinstance(n, tuple))
        spread = lambda t, spec: distribute_tensor(t.clone(), rmesh, placements(spec, rmesh))
        dparams = tree.unflatten(params, [spread(p, s) for p, s in zip(tree.leaves(params), leaves_of(specs))])
        dbatch = {k: spread(b, s) for (k, b), s in zip(batch.items(), leaves_of(rules.batch_specs(batch)))}
        opt_specs = leaves_of(rules.opt_specs(params))
        moments = lambda: tree.unflatten(params, [spread(torch.zeros(p.shape), s)
                                                  for p, s in zip(tree.leaves(params), opt_specs)])
        views = Zero3Views(dparams, fsdp_dim=0)
        paths = [p for p, _ in tree.leaves_with_path(params)]

        want_loss, _, want_grads = steps._grads(plain, params, batch)
        with implicit_replication(), views, CollectiveTrace() as grad_trace:
            loss, _, grads = steps._grads(sharded, dparams, dbatch)
            grads = steps._constrain(grads, leaves_of(named(rmesh, specs)))
        close(f"{label} loss", loss.full_tensor(), want_loss, **tol)
        for path, g, p_, w in zip(paths, grads, tree.leaves(dparams), want_grads, strict=True):
            assert g.placements == p_.placements, (label, path, g.placements, p_.placements)
            close(f"{label} grad {path}", g.full_tensor(), w, **tol)
        zero1 = sum(p.placements != m.placements
                    for p, m in zip(tree.leaves(dparams), tree.leaves(moments())))
        assert (zero1 > 0) == (variant.get("zero_stage", 3) == 1), (label, zero1)
        if zero1:  # gradients of parameters replicated over fsdp are all-reduced there, not scattered
            fsdp_group = rmesh.get_group(0).group_name
            assert not [op for op in grad_trace.ops if op.kind == "reduce-scatter" and op.group_name == fsdp_group]
            assert views.gathers == 0, (label, views.gathers)

        ref_params = tree.tree_map(lambda t: t.clone(), params)
        ref_params, ref_opt, ref_metrics = steps.make_train_step(plain, opt_cfg, microbatches=2)(
            ref_params, adamw.init(ref_params), batch)
        step = steps.make_train_step(sharded, opt_cfg, microbatches=2, grad_placements=named(rmesh, specs))
        dopt = adamw.AdamWState(torch.zeros((), dtype=torch.int32), moments(), moments())
        copies = tree.tree_map(lambda t: t.clone(), dparams)
        with implicit_replication(), CollectiveTrace() as trace:  # the update alone, on copies
            adamw.update(opt_cfg, tree.unflatten(dparams, grads),
                         adamw.AdamWState(torch.zeros((), dtype=torch.int32), moments(), moments()), copies)
        with implicit_replication(), views:
            new_params, new_opt, metrics = step(dparams, dopt, dbatch)
        gathers = [op for op in trace.ops if op.kind == "all-gather"]
        assert len(gathers) == zero1, (label, len(gathers), zero1)
        full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        close(f"{label} step loss", full(metrics["loss"]), ref_metrics["loss"], **tol)
        got_m = [t.full_tensor() for t in tree.leaves(new_opt.m)]
        for name, got, want in (("m", got_m, tree.leaves(ref_opt.m)),
                                ("v", [t.full_tensor() for t in tree.leaves(new_opt.v)], tree.leaves(ref_opt.v))):
            for path, g, w in zip(paths, got, want, strict=True):
                close(f"{label} {name} {path}", g, w, **tol)
        want_params = plain_update(opt_cfg, params, got_m)
        for path, g, p_, w in zip(paths, tree.leaves(new_params), tree.leaves(dparams), tree.leaves(want_params),
                                  strict=True):
            assert g.placements == p_.placements, (label, path)
            close(f"{label} param {path}", g.full_tensor(), w, **tol)
        return rmesh

    def rank_main(rank, port):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=N)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch import tree
        from repro_torch.analysis.roofline import CollectiveTrace
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import ShardingRules, mesh_axis_sizes, named, placements
        from repro_torch.launch.dryrun import Zero3Views, run_mesh
        from repro_torch.models import transformer
        from repro_torch.models.model import build_model
        from repro_torch.optim import adamw
        from repro_torch.train import steps

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(), param_dtype="float32",
                                  activation_dtype="float32")
        rules = ShardingRules(cfg, mesh_axis_sizes(mesh))
        rmesh = run_mesh(mesh, rules)
        plain = build_model(cfg)
        sharded = dataclasses.replace(plain, logits_sharding=lambda nd: placements(rules.logits_spec(nd), rmesh))
        opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int64))}

        params = plain.init(0, device="cpu")
        specs = rules.params_specs(params)
        spec_leaves = tree.leaves(specs, is_leaf=lambda n: isinstance(n, tuple))
        spread = lambda t, spec: distribute_tensor(t.clone(), rmesh, placements(spec, rmesh))
        dparams = tree.unflatten(params, [spread(p, s) for p, s in zip(tree.leaves(params), spec_leaves)])
        bspecs = tree.leaves(rules.batch_specs(batch), is_leaf=lambda n: isinstance(n, tuple))
        dbatch = tree.unflatten(batch, [spread(b, s) for b, s in zip(tree.leaves(batch), bspecs)])
        moments = lambda: tree.unflatten(params, [spread(torch.zeros(p.shape), s)
                                                  for p, s in zip(tree.leaves(params), spec_leaves)])
        dopt = adamw.AdamWState(torch.zeros((), dtype=torch.int32), moments(), moments())
        views = Zero3Views(dparams, fsdp_dim=0)

        # the accumulators are built from local shards: no gather of a parameter
        with implicit_replication(), CollectiveTrace() as trace, views:
            acc = [steps._zeros_f32(p) for p in tree.leaves(dparams)]
        assert trace.ops == [] and views.gathers == 0, (trace.stats(), views.gathers)
        assert [a.placements for a in acc] == [p.placements for p in tree.leaves(dparams)]

        # one microbatch's loss, gradients and global norm
        want_loss, _, want_grads = steps._grads(plain, params, batch)
        grad_pl = tree.leaves(named(rmesh, specs), is_leaf=lambda n: isinstance(n, tuple))
        cuts = []  # block remat keeps each layer's input as its slice over "model"
        cut = transformer._SequenceSlice.cut
        transformer._SequenceSlice.cut = lambda self: (cuts.append(1), cut(self))
        with implicit_replication(), views:
            loss, _, grads = steps._grads(sharded, dparams, dbatch)
        transformer._SequenceSlice.cut = cut
        assert len(cuts) == cfg.n_layers, cuts
        with implicit_replication(), views:
            grads = steps._constrain(grads, grad_pl)
            norm = adamw.global_norm(grads)
        close("loss", loss.full_tensor(), want_loss)
        paths = [p for p, _ in tree.leaves_with_path(params)]
        for path, g, p, w in zip(paths, grads, tree.leaves(dparams), want_grads, strict=True):
            assert g.placements == p.placements, (path, g.placements, p.placements)
            close(f"grad {path}", g.full_tensor(), w)
        close("global norm", norm, adamw.global_norm(want_grads))
        assert views.gathers > 0

        # the whole step: 2 microbatches, grad_placements, AdamW
        ref_params = tree.tree_map(lambda t: t.clone(), params)
        ref_params, ref_opt, ref_metrics = steps.make_train_step(plain, opt_cfg, microbatches=2)(
            ref_params, adamw.init(ref_params), batch)
        step = steps.make_train_step(sharded, opt_cfg, microbatches=2, grad_placements=named(rmesh, specs))
        with implicit_replication(), views:
            new_params, new_opt, metrics = step(dparams, dopt, dbatch)
        full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
        close("step loss", full(metrics["loss"]), ref_metrics["loss"])
        close("step grad norm", full(metrics["grad_norm"]), ref_metrics["grad_norm"])
        got_m = [t.full_tensor() for t in tree.leaves(new_opt.m)]
        for name, got, want in (("m", got_m, tree.leaves(ref_opt.m)),
                                ("v", [t.full_tensor() for t in tree.leaves(new_opt.v)], tree.leaves(ref_opt.v))):
            for path, g, w in zip(paths, got, want, strict=True):
                close(f"{name} {path}", g, w)
        # Adam's first step divides each gradient by its magnitude, so a
        # gradient near 0 that differs in its last bits moves its parameter
        # by up to lr: the parameters are held against the plain update of
        # the (clipped) gradients this step's moments hold
        want_params = plain_update(opt_cfg, params, got_m)
        for path, g, w in zip(paths, tree.leaves(new_params), tree.leaves(want_params), strict=True):
            close(f"param {path}", g.full_tensor(), w)
        moved = max(float((p.full_tensor() - q).abs().max())
                    for p, q in zip(tree.leaves(new_params), tree.leaves(params)))
        assert moved > 1e-4, moved

        # the dry-run's variants against the plain block-remat, unchunked step
        variant_step("zero1", mesh, cfg, {"zero_stage": 1}, opt_cfg, batch)
        flat = variant_step("zero1 no model axis", mesh, cfg,
                            {"zero_stage": 1, "model_axis": "none", "fsdp_axes": ["data", "model"]}, opt_cfg, batch)
        assert flat.mesh_dim_names == ("data+model",) and tuple(flat.shape) == (4,), flat
        variant_step("loss_chunk", mesh, cfg, {"loss_chunk": 8}, opt_cfg, batch)
        variant_step("remat dots", mesh, cfg, {"remat": "dots"}, opt_cfg, batch)
        dist.barrier()
        dist.destroy_process_group()
        print(f"OK rank {rank}", flush=True)

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(int(sys.argv[1]),), nprocs=N, join=True)
    """
)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_dtensor_train_step_matches_the_plain_step_on_four_gloo_ranks(tmp_path):
    """rtol 1e-5, atol 1e-6 on the loss, every gradient, the global norm,
    every moment and every updated parameter; the variants (ZeRO-1, no
    model axis, loss_chunk, remat="dots") at 2e-4 + 2e-4 |want|; 300 s
    timeout."""
    script = tmp_path / "step4.py"
    script.write_text(STEP_PROG)
    out = subprocess.run([sys.executable, str(script), str(_free_port())], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-6000:]
    assert sorted(int(r) for r in re.findall(r"OK rank (\d+)", out.stdout)) == list(range(4)), out.stdout
