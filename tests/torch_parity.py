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
