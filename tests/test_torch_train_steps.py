"""The port's train step against ``jax.jit(make_train_step)``: granite-3-8b,
zamba2-2.7b, rwkv6-3b and mixtral-8x7b (whose loss adds 0.01 x the MoE aux
loss in each microbatch; reduced, float32), microbatches 1 and 2, one and
three steps from the same parameters and batches.  Apart from
tests/test_torch_train.py because JAX's compiles take most of its time."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.optim import adamw as jax_adamw
from repro.train import make_train_step as jax_make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train import make_train_step
from torch_parity import assert_close, f32_pair, jax_setup, to_torch

TRAIN_ARCHS = ["granite-3-8b", "zamba2-2.7b", "rwkv6-3b", "mixtral-8x7b"]


def _assert_trees_close(got, want):
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert got_leaves.keys() == want_leaves.keys()
    for path, leaf in want_leaves.items():
        assert_close(got_leaves[path], leaf)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_train_steps_match_jax(name, microbatches):
    """Steps 1 and 3 from the same parameters and batches: loss, grad norm,
    learning rate, every parameter leaf and both moments at 2e-4."""
    jcfg, tcfg = f32_pair(name)
    cfg_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jmodel, jparams, _ = jax_setup(jcfg, 0, 4, 16)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, jcfg.vocab_size, (4, 16), dtype=np.int32) for _ in range(3)]
    jstep = jax.jit(jax_make_train_step(jmodel, jax_adamw.AdamWConfig(**cfg_kw), microbatches))
    step = make_train_step(build_model(tcfg), adamw.AdamWConfig(**cfg_kw), microbatches)
    jstate = jax_adamw.init(jparams)
    params = to_torch(jparams)
    state = adamw.init(params)
    for i, tokens in enumerate(batches):
        jparams, jstate, jm = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, m = step(params, state, {"tokens": torch.from_numpy(tokens).long()})
        assert m.keys() == jm.keys()
        if jcfg.moe is not None and microbatches == 1:
            assert "moe_aux_loss" in m
            assert_close(m["loss"], m["ce"] + 0.01 * m["moe_aux_loss"])
        for key in jm:
            assert_close(m[key], jm[key])
        if i in (0, 2):
            _assert_trees_close(params, jparams)
            _assert_trees_close(state.m, jstate.m)
            _assert_trees_close(state.v, jstate.v)
