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
    jmodel, jparams, tokens = jax_setup(jcfg, seed, B, S)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    model = build_model(tcfg, impl=impl)
    got, _ = model.forward(to_torch(jparams), {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (B, S, tcfg.padded_vocab_size)
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert_close(got, want, F32_TOL if f32 else BF16_TOL)


def check_decode_steps(name, steps=10, B=2, seed=2):
    """``decode_step`` against JAX's, step by step: logits and every cache
    leaf (the port writes its cache in place; JAX returns a new one)."""
    from repro_torch.models import build_model

    jcfg, tcfg = f32_pair(name)
    jmodel, jparams, tokens = jax_setup(jcfg, seed, B, steps)
    jcache = jmodel.init_cache(B, steps)
    jstep = jax.jit(jmodel.decode_step)
    model = build_model(tcfg)
    params = to_torch(jparams)
    cache = model.init_cache(B, steps, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in jcache.items()}
    for t in range(steps):
        want, jcache = jstep(jparams, jcache, {"tokens": jnp.asarray(tokens[:, t : t + 1])}, jnp.array(t))
        got, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(tokens[:, t : t + 1]).long()}, t
        )
        assert_close(got, want, F32_TOL)
        for leaf in jcache:
            assert_close(cache[leaf], jcache[leaf], F32_TOL)


def check_decode_matches_prefill(name, impl, B=2, S=12, seed=3):
    """Teacher-forced decode reproduces the full-sequence logits (the JAX
    invariant of test_arch_smoke.py, same bound)."""
    from repro_torch.models import build_model

    jcfg, tcfg = f32_pair(name)
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
