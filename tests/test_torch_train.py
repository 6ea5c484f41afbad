"""Training parity of the port against the JAX package: AdamW, its decay
mask and schedule, the eval step, remat, the chunked loss, the kernel
wrappers' refusal of autograd, and the torch trainer's CLI on the CPU
(the train step itself: tests/test_torch_train_steps.py).  Reduced float32
configs, inputs made with numpy from a seed, JAX parameters converted to
the port."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch import tree
from repro_torch.configs import all_archs
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train import make_eval_step, make_train_step
from torch_parity import (
    BF16_TOL,
    F32_TOL,
    assert_close,
    f32_pair,
    jax_batch,
    jax_setup,
    np_batch,
    to_torch,
    torch_batch,
)

TRAIN_ARCHS = ["granite-3-8b", "zamba2-2.7b", "rwkv6-3b"]
# the rest of the transformer family: MoE (its loss adds the aux term), VLM, audio
MORE_ARCHS = ["mixtral-8x7b", "internvl2-1b", "musicgen-large"]


def _assert_trees_close(got, want, tol=F32_TOL):
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert got_leaves.keys() == want_leaves.keys()
    for path, leaf in want_leaves.items():
        assert_close(got_leaves[path], leaf, tol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _adamw_case(rng):
    """A tree that meets every branch of the decay decision, with float32
    and bf16 leaves, and gradients large enough that clipping acts."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {
        "w": f32(3, 4, 5),
        "norm": {"scale": f32(3, 5)},
        "dt_bias": f32(3, 4),
        "b": f32(4),
        "wb": jnp.asarray(f32(6, 7), jnp.bfloat16),
        "w0": f32(2, 9),
    }
    grads = [jax.tree.map(lambda p: jnp.asarray(f32(*p.shape) * 3.0, p.dtype), params)
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("span", [adamw.SPAN, 7])  # 7: every leaf cut into several spans
def test_adamw_update_matches_jax(monkeypatch, span):
    monkeypatch.setattr(adamw, "SPAN", span)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=1.0)
    jparams, jgrads = _adamw_case(np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, jparams)
    jstate = jax_adamw.init(jparams)
    params = to_torch(jparams)
    state = adamw.init(params)
    jupdate = jax.jit(lambda g, s, p: jax_adamw.update(jax_adamw.AdamWConfig(**cfg_kw), g, s, p))
    for g in jgrads:
        jparams, jstate, jmetrics = jupdate(g, jstate, jparams)
        params, state, metrics = adamw.update(adamw.AdamWConfig(**cfg_kw), to_torch(g), state, params)
        for name in ("grad_norm", "lr"):
            assert_close(metrics[name], jmetrics[name])
        assert int(state.step) == int(jstate.step) and state.step.dtype == torch.int32
        for k in params:
            _assert_trees_close(params[k], jparams[k], BF16_TOL if k == "wb" else F32_TOL)
        assert [p.dtype for p in tree.leaves(params)] == [torch.bfloat16 if n == ("wb",) else torch.float32
                                                          for n, _ in tree.leaves_with_path(params)]
        _assert_trees_close(state.m, jstate.m)
        _assert_trees_close(state.v, jstate.v)


def test_adamw_moments_are_float32_and_update_in_place():
    params = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    state = adamw.init(params)
    assert state.m["w"].dtype == torch.float32 and state.step.shape == ()
    ptr = params["w"].data_ptr()
    new, state2, _ = adamw.update(adamw.AdamWConfig(warmup_steps=0), {"w": torch.ones(4, 3)},
                                  state, params)
    assert new["w"].data_ptr() == ptr and state2.m["w"] is state.m["w"]
    assert new["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(all_archs()))
def test_decay_decision_matches_jax(name):
    """For every leaf of every port config: JAX's ``_decay_mask(path) and
    p.ndim >= 2``, the stacked layer axis counted."""
    jcfg, tcfg = f32_pair(name)
    shapes = jax_build_model(jcfg).init_shapes()
    want = {tuple(k.key for k in path): jax_adamw._decay_mask(path) and leaf.ndim >= 2
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {path: adamw.decayed(path, p)
           for path, p in tree.leaves_with_path(build_model(tcfg).init(0, device="cpu"))}
    assert got == want
    if tcfg.ssm is not None:  # leaves whose decision turns on the name or the stacked axis
        assert not got[("mamba_layers", "mamba", "dt_bias")]
        assert got[("mamba_layers", "mamba", "norm")]
    if tcfg.rwkv is not None:
        for leaf in ("w0", "u", "ln_x"):
            assert got[("layers", "time_mix", leaf)]
        assert got[("layers", "channel_mix", "mix_k")]
        assert not got[("layers", "norm1", "bias")]


def test_schedule_matches_jax():
    cfg_kw = dict(lr=3e-3, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 200):
        want = jax_adamw.schedule(jax_adamw.AdamWConfig(**cfg_kw), jnp.array(step, jnp.int32))
        got = adamw.schedule(adamw.AdamWConfig(**cfg_kw), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    assert float(adamw.schedule(cfg, 0)) == 0.0
    assert float(adamw.schedule(cfg, 10)) == pytest.approx(1.0)
    assert float(adamw.schedule(cfg, 110)) == pytest.approx(0.1)


def test_grad_clipping_reports_the_norm_before_clipping():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    _, _, metrics = adamw.update(cfg, {"w": torch.tensor([1e6, -1e6, 1e6])}, adamw.init(params), params)
    assert float(metrics["grad_norm"]) > 1e5


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------
def test_train_step_refuses_the_kernel_paths():
    _, tcfg = f32_pair("granite-3-8b")
    with pytest.raises(ValueError, match="impl='torch'"):
        make_train_step(build_model(tcfg, impl="kernel"), adamw.AdamWConfig())


def test_eval_step_takes_the_kernel_paths():
    """The eval step through the kernels' plain versions equals the torch
    path's loss, and runs under inference_mode."""
    _, tcfg = f32_pair("zamba2-2.7b")
    params = build_model(tcfg).init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 16)))
    fast = make_eval_step(build_model(tcfg, impl="kernel"))(params, {"tokens": tokens})
    plain = make_eval_step(build_model(tcfg))(params, {"tokens": tokens})
    assert fast["loss"].is_inference()
    assert_close(fast["loss"], plain["loss"])


# ---------------------------------------------------------------------------
# Remat and the chunked loss
# ---------------------------------------------------------------------------
def _loss_grads(model, params, batch):
    live = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch)
    return loss, torch.autograd.grad(loss, tree.leaves(live))


@pytest.mark.parametrize("name", TRAIN_ARCHS + MORE_ARCHS)
def test_remat_block_gradients_equal_remat_none(name):
    _, tcfg = f32_pair(name)
    params = build_model(tcfg).init(0, device="cpu")
    batch = torch_batch(np_batch(tcfg, 2, 16, seed=3))
    l1, g1 = _loss_grads(build_model(tcfg, remat="block"), params, batch)
    l2, g2 = _loss_grads(build_model(tcfg, remat="none"), params, batch)
    assert float(l1.detach()) == float(l2.detach())
    assert max(float((a - b).abs().max()) for a, b in zip(g1, g2)) < 1e-6


@pytest.mark.parametrize("name", TRAIN_ARCHS + MORE_ARCHS)
def test_remat_dots_gives_block_loss_and_gradients(name):
    """remat="dots" (selective checkpointing of the weight products) gives
    remat="block"'s loss and gradients within the float32 tolerance."""
    _, tcfg = f32_pair(name)
    params = build_model(tcfg).init(0, device="cpu")
    batch = torch_batch(np_batch(tcfg, 2, 16, seed=3))
    l1, g1 = _loss_grads(build_model(tcfg, remat="dots"), params, batch)
    l2, g2 = _loss_grads(build_model(tcfg, remat="block"), params, batch)
    assert_close(l1.detach(), l2.detach())
    for a, b in zip(g1, g2):
        assert_close(a, b)


@pytest.mark.parametrize("name", ["granite-3-8b", "mixtral-8x7b", "musicgen-large"])
def test_remat_dots_gradients_match_jax(name):
    """The port's remat="dots" gradients against JAX's remat="dots"
    (checkpoint_dots_with_no_batch_dims) on the same parameters and batch,
    within the float32 tolerance."""
    jcfg, tcfg = f32_pair(name)
    jmodel, jparams, _ = jax_setup(jcfg, 0, 2, 16)
    jmodel = dataclasses.replace(jmodel, remat="dots")
    np_b = np_batch(jcfg, 2, 16, seed=4)
    (want_loss, _), want = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jax_batch(np_b))
    loss, grads = _loss_grads(build_model(tcfg, remat="dots"), to_torch(jparams), torch_batch(np_b))
    assert_close(loss.detach(), want_loss)
    for g, w in zip(grads, jax.tree.leaves(want), strict=True):
        assert_close(g, w)


def test_remat_dots_saves_the_weight_products():
    """The policy saves mm, addmm and a bmm of batch 1, and recomputes a
    batched bmm and elementwise ops."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models.transformer import _save_dots

    aten = torch.ops.aten
    save, redo = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    x2, x3 = torch.zeros(4, 4), torch.zeros(1, 4, 4)
    assert _save_dots(None, aten.mm.default, x2, x2) == save
    assert _save_dots(None, aten.addmm.default, x2, x2, x2) == save
    assert _save_dots(None, aten.bmm.default, x3, x3) == save
    assert _save_dots(None, aten.bmm.default, torch.zeros(2, 4, 4), torch.zeros(2, 4, 4)) == redo
    assert _save_dots(None, aten.mul.Tensor, x2, x2) == redo


@pytest.mark.parametrize("name", TRAIN_ARCHS + MORE_ARCHS)
def test_chunked_loss_matches_full_loss_and_jax(name):
    """As tests/test_arch_smoke.py:163: 19 positions, chunks of 8 plus a
    remainder of 3; equal to the full loss (and its gradients) within 1e-5,
    and to JAX's chunked loss within 2e-4 (the VLM's positions after its
    patches; musicgen's every codebook, counted in the mean)."""
    jcfg, tcfg = f32_pair(name)
    jmodel, jparams, _ = jax_setup(jcfg, 0, 2, 20)
    np_b = np_batch(jcfg, 2, 20, seed=0)
    want, _ = jax.jit(dataclasses.replace(jmodel, loss_chunk=8).loss)(jparams, jax_batch(np_b))
    params = to_torch(jparams)
    batch = torch_batch(np_b)
    full = build_model(tcfg)
    l1, g1 = _loss_grads(full, params, batch)
    l2, g2 = _loss_grads(dataclasses.replace(full, loss_chunk=8), params, batch)
    assert abs(float((l1 - l2).detach())) < 1e-5
    assert max(float((a - b).abs().max()) for a, b in zip(g1, g2)) < 1e-5
    assert_close(l2, want)


# ---------------------------------------------------------------------------
# The kernel wrappers refuse autograd (on the CPU as on the card)
# ---------------------------------------------------------------------------
def _wrapper_cases():
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    rn = lambda *s: torch.randn(*s)
    return {
        "flash_attention": (flash_ops.flash_attention, [rn(1, 16, 2, 8) for _ in range(3)]),
        "ssd_scan": (ssd_ops.ssd_scan, [rn(1, 16, 2, 4), torch.rand(1, 16, 2), -torch.rand(2),
                                        rn(1, 16, 1, 4), rn(1, 16, 1, 4)]),
        "rwkv6_mix": (rwkv6_ops.rwkv6_mix, [rn(1, 16, 2, 4), rn(1, 16, 2, 4), rn(1, 16, 2, 4),
                                            -torch.rand(1, 16, 2, 4), rn(2, 4)]),
    }


@pytest.mark.parametrize("wrapper", ["flash_attention", "ssd_scan", "rwkv6_mix"])
def test_kernel_wrapper_refuses_autograd(wrapper):
    fn, args = _wrapper_cases()[wrapper]
    fn(*args)  # no input needs a gradient: runs
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad():
        fn(*args)


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_kernel_model_refuses_autograd(name):
    _, tcfg = f32_pair(name)
    params = build_model(tcfg).init(0, device="cpu")
    live = tree.tree_map(lambda p: p.requires_grad_(), params)
    with pytest.raises(RuntimeError, match="no backward"):
        build_model(tcfg, impl="kernel").loss(live, {"tokens": torch.zeros(1, 8, dtype=torch.long)})


# ---------------------------------------------------------------------------
# The trainer's CLI on the CPU
# ---------------------------------------------------------------------------
def test_train_main_loss_decreases(capsys):
    """Reduced granite, 30 steps, microbatches 2: the loss falls by at least
    0.5, as test_substrate.py::test_training_loss_decreases holds JAX's."""
    from repro_torch.launch import train

    first, last = train.main(["--device", "cpu", "--steps", "30", "--batch", "4", "--seq", "32",
                              "--microbatches", "2"])
    assert last < first - 0.5, (first, last)
    assert "device=cpu" in capsys.readouterr().out


def _step_8_arrays(root):
    out = {}
    for f in sorted((root / "step_000000008").glob("shard_*.npz")):
        with np.load(f) as z:
            out.update({k: z[k] for k in z.files})
    return out


def test_train_main_resume_and_failure_reproduce_the_run(tmp_path, capsys):
    """A run resumed from its step-4 checkpoint ends bit-equal to the run
    that was not interrupted; a simulated failure restores the last
    checkpoint and finishes."""
    import shutil

    from repro_torch.launch import train

    common = ["--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "16", "--ckpt-every", "4"]
    train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_000000008")
    (tmp_path / "b" / "step_000000008.COMMIT").unlink()
    train.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert "resumed from checkpoint step 4" in capsys.readouterr().out
    a, b = _step_8_arrays(tmp_path / "a"), _step_8_arrays(tmp_path / "b")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])

    first, last = train.main(common + ["--ckpt-dir", str(tmp_path / "c"),
                                       "--simulate-failure-at", "6", "--compress", "int8"])
    out = capsys.readouterr().out
    assert "[fault] restored checkpoint step 4" in out
    assert np.isfinite([first, last]).all()


def test_train_cli_flags():
    from repro_torch.launch import train

    ap = train.build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--full"]).reduced is False
    assert ap.parse_args([]).device == "cuda"
    assert ap.parse_args([]).plan_shape == "train_4k"
    with pytest.raises(SystemExit):  # --plan-chips needs --plan-pod: the port has no default pod
        train.main(["--plan-chips", "64"])
