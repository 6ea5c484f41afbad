"""Shared helpers for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).  Inputs are made with numpy from a fixed
seed and handed to both frameworks; JAX parameters reach the port through
``repro_torch.interop.params_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.interop import params_from_jax

DENSE_ARCHS = ["granite-3-8b", "llama3-70b", "qwen1.5-110b", "nemotron-4-340b", "command-r-35b"]
MOE_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
MODALITY_ARCHS = ["internvl2-1b", "musicgen-large"]
F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def cfg_pair(name, reduced=True, **overrides):
    """The same configuration from both packages (``reduced()`` unless
    asked otherwise), with ``overrides`` applied to each."""
    pair = []
    for get in (jax_get_arch, torch_get_arch):
        cfg = get(name)
        if reduced:
            cfg = cfg.reduced()
        pair.append(dataclasses.replace(cfg, **overrides))
    return tuple(pair)


def f32_pair(name, **overrides):
    return cfg_pair(name, param_dtype="float32", activation_dtype="float32", **overrides)


def with_capacity(pair, factor):
    """A config pair with the MoE capacity factor set to ``factor`` (each
    package has its own ``MoEConfig``); a pair without MoE as it is."""
    return tuple(
        cfg if cfg.moe is None
        else dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
        for cfg in pair
    )


def no_drop_pair(pair):
    """The pair at the serve check's no-drop capacity factor, E / k."""
    cfg = pair[1]
    return pair if cfg.moe is None else with_capacity(pair, cfg.moe.num_experts / cfg.moe.top_k)


def rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


def to_torch(tree, device="cpu"):
    """A JAX (or numpy) tree as the port's tensors."""
    return params_from_jax(jax.tree.map(np.asarray, tree), device)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def np_batch(cfg, B, S, seed):
    """A batch of the family's structure, made with numpy from ``seed``:
    tokens (the draw ``jax_setup`` makes); for audio, frame embeddings and
    per-codebook targets instead; for VLM, patch embeddings beside them."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        frames = rand(rng, (B, S, cfg.d_model))
        targets = rng.integers(0, cfg.vocab_size, (B, S, cfg.n_codebooks), dtype=np.int32)
        return {"frame_embeds": frames, "targets": targets}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
    if cfg.frontend == "vlm":
        out["patch_embeds"] = rand(rng, (B, cfg.num_patches, cfg.d_model))
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch, device="cpu"):
    """A numpy batch as the port's tensors: ids as int64, embeddings float32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v))
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


def step_slice(batch, t):
    """Decode step ``t``'s input: one token, or one audio frame (a VLM
    decodes tokens only; its patches are not fed again)."""
    if "frame_embeds" in batch:
        return {"frame_embeds": batch["frame_embeds"][:, t : t + 1]}
    return {"tokens": batch["tokens"][:, t : t + 1]}


# ---------------------------------------------------------------------------
# Family-level checks shared by the per-family test files
# ---------------------------------------------------------------------------
def jax_setup(jcfg, seed, B, S):
    """The JAX model, its parameters from ``seed``, and (B, S) tokens."""
    from repro.models import build_model as jax_build_model

    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    return jmodel, jparams, tokens


def check_param_tree(name):
    """The port's random parameters have the JAX tree's paths, shapes and
    dtypes, and converted JAX parameters keep them."""
    from repro.models import build_model as jax_build_model
    from repro_torch.models import build_model

    jcfg, tcfg = cfg_pair(name)
    jshapes = jax.tree_util.tree_leaves_with_path(jax_build_model(jcfg).init_shapes())
    params = build_model(tcfg).init(0, device="cpu")
    tleaves = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(tleaves) == len(jshapes)
    for path, leaf in jshapes:
        got = tleaves[path]
        assert tuple(got.shape) == leaf.shape, path
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype), path
    converted = dict(jax.tree_util.tree_leaves_with_path(
        to_torch(jax_build_model(jcfg).init(jax.random.key(0)))))
    assert converted.keys() == tleaves.keys()


def check_forward(name, impl, f32=True, B=2, S=16, seed=0):
    """Forward logits against JAX's ``forward`` on the same parameters."""
    from repro_torch.models import build_model

    jcfg, tcfg = f32_pair(name) if f32 else cfg_pair(name)
    jmodel, jparams, _ = jax_setup(jcfg, seed, B, S)
    batch = np_batch(jcfg, B, S, seed)
    want, _ = jax.jit(jmodel.forward)(jparams, jax_batch(batch))
    model = build_model(tcfg, impl=impl)
    got, _ = model.forward(to_torch(jparams), torch_batch(batch))
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert_close(got, want, F32_TOL if f32 else BF16_TOL)


def check_decode_steps(name, steps=10, B=2, seed=2, **overrides):
    """``decode_step`` against JAX's, step by step: logits and every cache
    leaf (the port writes its cache in place; JAX returns a new one)."""
    from repro_torch.models import build_model

    jcfg, tcfg = f32_pair(name, **overrides)
    jmodel, jparams, _ = jax_setup(jcfg, seed, B, steps)
    batch = np_batch(jcfg, B, steps, seed)
    jcache = jmodel.init_cache(B, steps)
    jstep = jax.jit(jmodel.decode_step)
    model = build_model(tcfg)
    params = to_torch(jparams)
    cache = model.init_cache(B, steps, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in jcache.items()}
    for t in range(steps):
        want, jcache = jstep(jparams, jcache, jax_batch(step_slice(batch, t)), jnp.array(t))
        got, cache = model.decode_step(params, cache, torch_batch(step_slice(batch, t)), t)
        assert_close(got, want, F32_TOL)
        for leaf in jcache:
            assert_close(cache[leaf], jcache[leaf], F32_TOL)


def check_decode_matches_prefill(name, impl, B=2, S=12, seed=3):
    """Teacher-forced decode reproduces the full-sequence logits (the JAX
    invariant of test_arch_smoke.py, same bound); an MoE config at the
    no-drop capacity, as there."""
    from repro_torch.models import build_model

    jcfg, tcfg = no_drop_pair(f32_pair(name))
    _, jparams, tokens = jax_setup(jcfg, seed, B, S)
    params = to_torch(jparams)
    model = build_model(tcfg, impl=impl)
    t_tokens = torch.from_numpy(tokens).long()
    full, _ = model.forward(params, {"tokens": t_tokens})
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        logits_t, cache = model.decode_step(params, cache, {"tokens": t_tokens[:, t : t + 1]}, t)
        assert float((logits_t[:, 0] - full[:, t]).abs().max()) < 3e-4


def check_serve_on_cpu(name, capsys):
    """The reduced serve CLI runs on the CPU: the kernel prefill takes the
    plain versions (no launch), agrees with the teacher-forced decode, and
    every id lies below the vocabulary."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve

    counters = [flash_ops, ssd_ops, rwkv6_ops]
    before = [m.launches for m in counters]
    result = serve.main(["--arch", name, "--device", "cpu", "--requests", "2",
                         "--prompt-len", "12", "--gen-len", "4"])
    assert [m.launches for m in counters] == before
    assert result["tokens"].shape == (2, 4)
    assert 0 <= result["tokens"].min() and result["tokens"].max() < 128  # reduced vocabulary
    assert result["prefill_decode_max_abs_diff"] <= result["prefill_decode_tol"]
    assert f"arch={name}-smoke" in capsys.readouterr().out
