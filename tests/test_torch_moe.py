"""Mixture-of-experts parity: the port's ``models/moe.py`` against the JAX
package's ``repro.models.moe`` (capacity, routing with its tie order,
dispatch with drops, the expert products, the combine, the aux metrics and
their gradients), and the MoE configs through the model: mixtral-8x7b's
sliding window in decode (the ring buffer) and in the full forward.
Reduced configs, inputs made with numpy from a seed, JAX parameters
converted to the port."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import moe as jax_moe
from repro_torch import tree
from repro_torch.models import build_model, moe
from torch_parity import (
    BF16_TOL,
    F32_TOL,
    MOE_ARCHS,
    assert_close,
    cfg_pair,
    check_decode_steps,
    f32_pair,
    jax_setup,
    rand,
    to_torch,
    with_capacity,
)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_expert_capacity_matches_jax(name, reduced):
    for factor in (1.0, 1.25, 8.0):
        jcfg, tcfg = with_capacity(cfg_pair(name, reduced=reduced), factor)
        for T in list(range(1, 130)) + [255, 256, 511, 512, 513, 768, 4096]:
            assert moe.expert_capacity(tcfg, T) == jax_moe.expert_capacity(jcfg, T), (factor, T)
    _, tcfg = cfg_pair(name)
    assert moe.expert_capacity(tcfg, 1) == 4  # decode: one token per group never drops (k = 2)


def test_expert_capacity_at_the_serve_shapes():
    """512-token prompts: the configured factor drops, E / k does not."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import no_drop_config

    assert moe.expert_capacity(get_arch("mixtral-8x7b"), 512) == 160
    assert moe.expert_capacity(get_arch("phi3.5-moe-42b-a6.6b"), 512) == 80
    for name in MOE_ARCHS:
        assert moe.expert_capacity(no_drop_config(get_arch(name)), 512) >= 512


@pytest.mark.parametrize(
    "row",
    [
        [0.25, 0.25, 0.25, 0.25],  # all tied: the two lowest ids
        [0.1, 0.3, 0.3, 0.3],  # three tied after the first
        [0.4, 0.1, 0.4, 0.1],  # the top two tied, apart
        [0.1, 0.2, 0.2, 0.5],  # a tie for second place
    ],
)
def test_top_k_breaks_ties_like_lax(row):
    probs = np.array([row, row[::-1]], np.float32)
    want_w, want_ids = jax.lax.top_k(jnp.asarray(probs), 2)
    got_w, got_ids = moe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def _moe_case(jcfg, seed, B=2, S=64, skew=0.0):
    """JAX MoE parameters and an input of (B, S, d) normals plus ``skew``
    times one direction shared by every token (which crowds the router
    onto few experts, so that the configured capacity drops), each token
    scaled to unit RMS, as the block's pre-norm gives the layer its input."""
    p = jax_moe.init_moe(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    x = rand(rng, (B, S, jcfg.d_model)) + skew * rand(rng, (1, 1, jcfg.d_model))
    return p, x / np.sqrt((x * x).mean(-1, keepdims=True))


def _dtype_pair(name, dtype):
    return f32_pair(name) if dtype == "float32" else cfg_pair(name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", ["configured", "no-drop"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_apply_moe_matches_jax(name, capacity, dtype):
    """Output, aux loss and drop rate at the configured capacity factor
    (1.25, with drops) and at E / k (none), in float32 at 2e-4 and in bf16
    at 2e-2."""
    jcfg, tcfg = _dtype_pair(name, dtype)
    if capacity == "no-drop":
        jcfg, tcfg = with_capacity((jcfg, tcfg), tcfg.moe.num_experts / tcfg.moe.top_k)
    p, x = _moe_case(jcfg, seed=1, skew=1.5)
    act = jnp.dtype(jcfg.activation_dtype)
    want, want_aux = jax.jit(lambda p, x: jax_moe.apply_moe(p, x, jcfg))(p, jnp.asarray(x, act))
    got, aux = moe.apply_moe(to_torch(p), torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    assert got.shape == x.shape and got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert_close(got, want, tol)
    assert_close(aux["moe_aux_loss"], want_aux["moe_aux_loss"], tol)
    assert float(aux["moe_drop_rate"]) == float(want_aux["moe_drop_rate"])
    if capacity == "configured":
        assert float(aux["moe_drop_rate"]) > 0.0
    else:
        assert float(aux["moe_drop_rate"]) == 0.0


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_apply_moe_gradients_match_jax(name):
    """The gradients of the output (against a fixed cotangent) plus the aux
    loss with respect to every parameter and the input, at the configured
    capacity (with drops), float32."""
    jcfg, tcfg = f32_pair(name)
    p, x = _moe_case(jcfg, seed=2, skew=1.5)
    cot = rand(np.random.default_rng(3), x.shape)

    def jax_obj(p, x):
        y, aux = jax_moe.apply_moe(p, x, jcfg)
        return jnp.sum(y * cot) + aux["moe_aux_loss"]

    want_gp, want_gx = jax.jit(jax.grad(jax_obj, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in to_torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(tp, tx, tcfg)
    obj = torch.sum(y * torch.from_numpy(cot)) + aux["moe_aux_loss"]
    grads = torch.autograd.grad(obj, [tp[k] for k in sorted(tp)] + [tx])
    for k, g in zip(sorted(tp), grads):
        assert_close(g, want_gp[k])
    assert_close(grads[-1], want_gx)


def test_combine_of_two_terms_is_exact_in_bf16():
    """With k = 2 and no drops every token's combine adds two bf16 terms to
    zero, exact in any order: where the expert products are exact, the
    port's bf16 output equals JAX's bit for bit."""
    jcfg, tcfg = with_capacity(cfg_pair("mixtral-8x7b", mlp_act="relu2"), 2.0)
    # identity experts on quarter-step inputs: each expert returns relu(x)^2 exactly
    E, d, ff = jcfg.moe.num_experts, jcfg.d_model, jcfg.d_ff
    p = jax_moe.init_moe(jax.random.key(0), jcfg)
    eye = np.zeros((E, d, ff), np.float32)
    eye[:, np.arange(d), np.arange(d)] = 1.0
    p = dict(p, wi=jnp.asarray(eye, jnp.bfloat16), wo=jnp.asarray(eye.transpose(0, 2, 1), jnp.bfloat16))
    x = np.round(rand(np.random.default_rng(4), (2, 16, d)) * 4) / 4
    want, _ = jax_moe.apply_moe(p, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, _ = moe.apply_moe(to_torch(p), torch.from_numpy(x).to(torch.bfloat16), tcfg)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_init_moe_shapes_dtypes_and_scale():
    """The JAX layout, stacked on the layer axis: a float32 router and
    expert weights in the parameter dtype, drawn at 1/sqrt(fan-in); the
    same seed gives the same draws."""
    _, tcfg = cfg_pair("mixtral-8x7b")
    d, ff, E = tcfg.d_model, tcfg.d_ff, tcfg.moe.num_experts
    gen = lambda: torch.Generator().manual_seed(0)
    p = moe.init_moe(gen(), tcfg, torch.bfloat16, "cpu", lead=(3,))
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in p.items()}
    assert shapes == {
        "router": ((3, d, E), torch.float32),
        "wi": ((3, E, d, ff), torch.bfloat16),
        "wg": ((3, E, d, ff), torch.bfloat16),
        "wo": ((3, E, ff, d), torch.bfloat16),
    }
    for k, fan_in in (("wi", d), ("wo", ff)):
        std = float(p[k].float().std())
        assert abs(std * fan_in**0.5 - 1.0) < 0.05, (k, std)
    again = moe.init_moe(gen(), tcfg, torch.bfloat16, "cpu", lead=(3,))
    assert all(torch.equal(p[k], again[k]) for k in p)
    _, gelu_cfg = cfg_pair("mixtral-8x7b", mlp_act="gelu")
    assert "wg" not in moe.init_moe(gen(), gelu_cfg, torch.float32, "cpu")


def _routing(monkeypatch, jcfg, tcfg, seed, B=2, S=16):
    """Each layer's router probabilities and top-k ids in both packages'
    bf16 forwards (JAX's unjitted, without remat, to see its values)."""
    from repro.models import build_model as jax_build_model

    jmodel = jax_build_model(jcfg, remat="none")
    jparams = jmodel.init(jax.random.key(seed))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    seen = {"jax": [], "torch": []}
    jax_top_k, torch_top_k = jax.lax.top_k, moe.top_k

    def record_jax(p, k):
        w, i = jax_top_k(p, k)
        seen["jax"].append((np.asarray(p), np.asarray(i)))
        return w, i

    def record_torch(p, k):
        w, i = torch_top_k(p, k)
        seen["torch"].append((p.numpy().copy(), i.numpy().copy()))
        return w, i

    monkeypatch.setattr(jax.lax, "top_k", record_jax)
    monkeypatch.setattr(moe, "top_k", record_torch)
    with jax.disable_jit():
        jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        build_model(tcfg, impl="kernel").forward(to_torch(jparams), {"tokens": torch.from_numpy(tokens).long()})
    return seen["jax"], seen["torch"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_bf16_routing_differs_from_jax_only_at_near_ties(monkeypatch, name, seed):
    """In bf16 the two packages' hidden states differ by rounding, so a
    top-k choice can flip where the k-th and (k+1)-th probabilities nearly
    tie (phi, seed 1: 0.1854 / 0.1840 in the port against 0.18593 /
    0.18601 in JAX at layer 1).  Every disagreement must be such a tie, and
    the probabilities agree within the bf16 tolerance everywhere."""
    jcfg, tcfg = cfg_pair(name)
    k = tcfg.moe.top_k
    for (pj, ij), (pt, it) in zip(*_routing(monkeypatch, jcfg, tcfg, seed)):
        np.testing.assert_allclose(pt, pj, **BF16_TOL)
        for b, s in np.argwhere((ij != it).any(-1)):
            gap = lambda p: np.sort(p[b, s])[::-1][k - 1] - np.sort(p[b, s])[::-1][k]
            assert min(gap(pj), gap(pt)) < BF16_TOL["atol"], (b, s, pj[b, s], pt[b, s])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_model_loss_adds_the_aux_term(name):
    """loss = ce + 0.01 * moe_aux_loss, each metric the mean over layers,
    as JAX's; drops are reported."""
    jcfg, tcfg = f32_pair(name)
    jmodel, jparams, tokens = jax_setup(jcfg, 0, 2, 32)
    want, want_m = jax.jit(jmodel.loss)(jparams, {"tokens": jnp.asarray(tokens)})
    loss, m = build_model(tcfg).loss(to_torch(jparams), {"tokens": torch.from_numpy(tokens).long()})
    assert set(m) == set(want_m) == {"ce", "moe_aux_loss", "moe_drop_rate"}
    assert_close(loss, want)
    for k in want_m:
        assert_close(m[k], want_m[k])
    assert float(loss) == pytest.approx(float(m["ce"]) + 0.01 * float(m["moe_aux_loss"]), rel=1e-6)
    assert 0.0 <= float(m["moe_drop_rate"]) <= 1.0
    assert float(m["moe_aux_loss"]) >= 0.99


def test_mixtral_decode_wraps_the_window():
    """Reduced mixtral (window 8) decoded 18 steps against JAX, logits and
    the whole ring-buffer cache after every step: 10 steps past the window."""
    check_decode_steps("mixtral-8x7b", steps=18)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_mixtral_sliding_window_masks_distant_tokens(impl):
    """tests/test_arch_smoke.py's window test on the port: a token more than
    the window (8) before the last position does not reach its logits.  At
    S = 32 > window the forward takes the banded path whatever ``impl`` is
    (the reference's ``run_attention`` sends every S > window there)."""
    jcfg, tcfg = f32_pair("mixtral-8x7b", n_layers=1)
    jcfg, tcfg = with_capacity((jcfg, tcfg), 16.0)
    jmodel, jparams, tokens = jax_setup(jcfg, 0, 1, 32)
    tokens2 = tokens.copy()
    tokens2[0, 0] = (tokens[0, 0] + 1) % tcfg.vocab_size
    model = build_model(tcfg, impl=impl)
    params = to_torch(jparams)
    l1, _ = model.forward(params, {"tokens": torch.from_numpy(tokens).long()})
    l2, _ = model.forward(params, {"tokens": torch.from_numpy(tokens2).long()})
    assert float((l1[0, -1] - l2[0, -1]).abs().max()) < 1e-5
    assert float((l1[0, 0] - l2[0, 0]).abs().max()) > 1e-3  # the change does reach position 0
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    assert_close(l1, want)


def test_flash_route_gets_a_window_no_shorter_than_the_sequence(monkeypatch):
    """Up to S = window the model's flash route receives the config's
    window, which then masks no key (the kernel's window masking is held by
    the kernel sweeps alone); above it the banded path runs instead."""
    from repro_torch.kernels.attention import ops

    _, tcfg = f32_pair("mixtral-8x7b")
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: seen.append((q.shape[1], kw["window"])) or real(q, k, v, **kw))
    model = build_model(tcfg, impl="kernel")
    params = model.init(0, device="cpu")
    for S in (4, 8, 16):
        model.forward(params, {"tokens": torch.zeros(1, S, dtype=torch.long)})
    assert seen == [(4, 8)] * tcfg.n_layers + [(8, 8)] * tcfg.n_layers
    assert all(window >= S for S, window in seen)


def test_moe_block_is_the_parallel_block_too():
    """A parallel (Command-R style) block with an MoE layer in place of its
    MLP, against JAX's."""
    jcfg, tcfg = f32_pair("mixtral-8x7b", parallel_block=True)
    jmodel, jparams, tokens = jax_setup(jcfg, 5, 2, 16)
    want, want_aux = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = build_model(tcfg).forward(to_torch(jparams), {"tokens": torch.from_numpy(tokens).long()})
    assert_close(got, want)
    assert_close(aux["moe_aux_loss"], want_aux["moe_aux_loss"])
    assert "norm_mlp" not in build_model(tcfg).init(0, device="cpu")["layers"]


def test_remat_block_returns_the_aux_too():
    """Under remat ``"block"`` the checkpointed body returns (x, aux); the
    forward's aux and the gradients equal those without remat."""
    _, tcfg = f32_pair("mixtral-8x7b")
    params = build_model(tcfg).init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 16)))
    out = []
    for remat in ("block", "none"):
        live = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, m = build_model(tcfg, remat=remat).loss(live, {"tokens": tokens})
        out.append((float(loss), float(m["moe_aux_loss"]),
                    torch.autograd.grad(loss, tree.leaves(live))))
    (l1, a1, g1), (l2, a2, g2) = out
    assert l1 == l2 and a1 == a2
    assert max(float((a - b).abs().max()) for a, b in zip(g1, g2)) < 1e-6
