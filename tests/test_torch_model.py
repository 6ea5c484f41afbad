"""Model parity: the port's forward, loss and decode against the JAX
package's ``Model`` on the reduced transformer configs (dense, MoE, VLM,
audio), from JAX-initialised parameters converted with
``params_from_jax``."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import all_archs as jax_all_archs
from repro.models import build_model as jax_build_model
from repro_torch.configs import all_archs
from repro_torch.models import build_model
from torch_parity import (
    BF16_TOL,
    DENSE_ARCHS,
    F32_TOL,
    MODALITY_ARCHS,
    MOE_ARCHS,
    assert_close,
    cfg_pair,
    f32_pair,
    jax_batch,
    no_drop_pair,
    np_batch,
    to_torch,
    torch_batch,
)

B, S = 2, 16


def _setup(jcfg, seed=0):
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    return jmodel, jparams, tokens


@pytest.mark.parametrize("name", DENSE_ARCHS + MOE_ARCHS + MODALITY_ARCHS)
def test_forward_and_loss_match_jax(name):
    """Logits (B, S, V); (B, P + S, V) for the VLM, (B, S, codebooks, V)
    for audio), the aux metrics, the loss and its CE."""
    jcfg, tcfg = f32_pair(name)
    jmodel, jparams, _ = _setup(jcfg)
    np_b = np_batch(jcfg, B, S, seed=0)
    want_logits, want_aux = jax.jit(jmodel.forward)(jparams, jax_batch(np_b))
    want_loss, want_metrics = jax.jit(jmodel.loss)(jparams, jax_batch(np_b))

    params = to_torch(jparams)
    batch = torch_batch(np_b)
    model = build_model(tcfg)
    logits, aux = model.forward(params, batch)
    S_out = S + (tcfg.num_patches if tcfg.frontend == "vlm" else 0)
    V = tcfg.padded_vocab_size
    assert logits.shape == ((B, S_out, tcfg.n_codebooks, V) if tcfg.n_codebooks > 1 else (B, S_out, V))
    assert_close(logits, want_logits, F32_TOL)
    assert aux.keys() == want_aux.keys()
    for k in want_aux:
        assert_close(aux[k], want_aux[k], F32_TOL)
    loss, metrics = model.loss(params, batch)
    assert_close(loss, want_loss, F32_TOL)
    assert_close(metrics["ce"], want_metrics["ce"], F32_TOL)


def test_forward_bf16_matches_jax():
    jcfg, tcfg = cfg_pair("granite-3-8b")  # bfloat16 parameters and activations
    jmodel, jparams, tokens = _setup(jcfg, seed=1)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    params = to_torch(jparams)
    assert params["embed"].dtype == torch.bfloat16
    got, _ = build_model(tcfg, impl="kernel").forward(
        params, {"tokens": torch.from_numpy(tokens).long()}
    )
    assert got.dtype == torch.bfloat16
    assert_close(got, want, BF16_TOL)


@pytest.mark.parametrize("name", MODALITY_ARCHS)
def test_forward_bf16_matches_jax_modality(name):
    """bf16 parameters and activations through the kernel paths (the plain
    versions here), against JAX at 2e-2.  (An MoE model in bf16 can route
    a near-tie differently from JAX: tests/test_torch_moe.py holds its bf16
    routing and its layer instead.)"""
    jcfg, tcfg = cfg_pair(name)
    jmodel, jparams, _ = _setup(jcfg, seed=1)
    np_b = np_batch(jcfg, B, S, seed=1)
    want, _ = jax.jit(jmodel.forward)(jparams, jax_batch(np_b))
    params = to_torch(jparams)
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    got, _ = build_model(tcfg, impl="kernel").forward(params, torch_batch(np_b))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, BF16_TOL)


@pytest.mark.parametrize("name,window", [("granite-3-8b", None), ("command-r-35b", None), ("granite-3-8b", 4)])
def test_decode_step_matches_jax_step_by_step(name, window):
    """Logits and the whole cache after every step; window 4 < 10 steps
    exercises the ring-buffer write."""
    jcfg, tcfg = f32_pair(name, sliding_window=window)
    jmodel, jparams, tokens = _setup(jcfg, seed=2)
    steps = 10
    jcache = jmodel.init_cache(B, steps)
    jstep = jax.jit(jmodel.decode_step)
    model = build_model(tcfg)
    params = to_torch(jparams)
    cache = model.init_cache(B, steps, device="cpu")
    assert cache["k"].shape == jcache["k"].shape
    for t in range(steps):
        want, jcache = jstep(jparams, jcache, {"tokens": jnp.asarray(tokens[:, t : t + 1])}, jnp.array(t))
        got, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(tokens[:, t : t + 1]).long()}, t)
        assert_close(got, want, F32_TOL)
        assert_close(cache["k"], jcache["k"], F32_TOL)
        assert_close(cache["v"], jcache["v"], F32_TOL)


@pytest.mark.parametrize("attention", ["torch", "flash"])
@pytest.mark.parametrize("name", ["granite-3-8b", "nemotron-4-340b"] + MOE_ARCHS)
def test_decode_matches_prefill(name, attention):
    """Teacher-forced decode reproduces the full-sequence logits (the JAX
    invariant of test_arch_smoke.py, same bound); an MoE at the no-drop
    capacity E / k, as the serve check runs it (JAX's test takes 8)."""
    jcfg, tcfg = no_drop_pair(f32_pair(name))
    _, jparams, tokens = _setup(jcfg, seed=3)
    params = to_torch(jparams)
    model = build_model(tcfg, impl="kernel" if attention == "flash" else "torch")
    t_tokens = torch.from_numpy(tokens).long()
    full, _ = model.forward(params, {"tokens": t_tokens})
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        logits_t, cache = model.decode_step(params, cache, {"tokens": t_tokens[:, t : t + 1]}, t)
        assert float((logits_t[:, 0] - full[:, t]).abs().max()) < 3e-4


@pytest.mark.parametrize("name", sorted(jax_all_archs()))
def test_param_count_matches_jax(name):
    for reduced in (False, True):
        jcfg, tcfg = cfg_pair(name, reduced=reduced)
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.padded_vocab_size == jcfg.padded_vocab_size


def test_port_registers_every_jax_config():
    assert sorted(all_archs()) == sorted(jax_all_archs())
    assert len(all_archs()) == 11


def test_converted_params_keep_paths_shapes_and_dtypes():
    jcfg, _ = cfg_pair("qwen1.5-110b")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    params = to_torch(jparams)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        got = tleaves[path]
        assert tuple(got.shape) == leaf.shape
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf.astype(jnp.float32)))


def test_init_is_seeded_and_shaped_like_jax():
    jcfg, tcfg = cfg_pair("command-r-35b")
    jshapes = jax.tree.map(lambda x: x.shape, jax_build_model(jcfg).init_shapes())
    model = build_model(tcfg)
    a, b = model.init(0, device="cpu"), model.init(0, device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), a) == jshapes
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_entry_points_default_to_cuda():
    _, tcfg = cfg_pair("granite-3-8b")
    model = build_model(tcfg)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 4)
