"""Layer parity: ``repro_torch.models.layers`` against ``repro.models.layers``
on the same numpy inputs (float32, tolerance 2e-4)."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import layers as jl
from repro_torch.models import layers as tl
from torch_parity import assert_close, f32_pair, rand, to_torch

B, S = 2, 16


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jcfg, tcfg = f32_pair("granite-3-8b", norm=norm)
    rng = np.random.default_rng(0)
    x = rand(rng, (B, S, jcfg.d_model), 3.0)
    p = {"scale": 1.0 + rand(rng, (jcfg.d_model,), 0.1)}
    if norm == "layernorm":
        p["bias"] = rand(rng, (jcfg.d_model,), 0.1)
    want = jl.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = tl.apply_norm(to_torch(p), torch.from_numpy(x), tcfg)
    assert_close(got, want)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rand(rng, (B, 40, 4, 16))
    pos = np.arange(100, 140)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert_close(got, want)


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "relu2", "gelu"])
def test_apply_mlp(act):
    jcfg, tcfg = f32_pair("granite-3-8b", mlp_act=act)
    rng = np.random.default_rng(2)
    d = jcfg.d_model
    p = {k: rand(rng, s, s[0] ** -0.5) for k, s in jl.mlp_param_shapes(jcfg).items()}
    x = rand(rng, (B, S, d))
    want = jl.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got = tl.apply_mlp(to_torch(p), torch.from_numpy(x), tcfg)
    assert_close(got, want)


def _attn_params(jcfg, seed):
    rng = np.random.default_rng(seed)
    d, H, K, hd = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim
    p = {
        "wq": rand(rng, (d, H, hd), d ** -0.5),
        "wk": rand(rng, (d, K, hd), d ** -0.5),
        "wv": rand(rng, (d, K, hd), d ** -0.5),
        "wo": rand(rng, (H, hd, d), (H * hd) ** -0.5),
    }
    if jcfg.attn_bias:
        p.update(bq=rand(rng, (H, hd), 0.1), bk=rand(rng, (K, hd), 0.1), bv=rand(rng, (K, hd), 0.1))
    return p


def _qkv(seed, H, K, hd, s=S):
    rng = np.random.default_rng(seed)
    return [rand(rng, (B, s, n, hd)) for n in (H, K, K)]


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen1.5-110b"])  # qwen: QKV bias
def test_qkv_project(name):
    jcfg, tcfg = f32_pair(name)
    p = _attn_params(jcfg, 3)
    x = rand(np.random.default_rng(4), (B, S, jcfg.d_model))
    pos = np.arange(S)
    want = jl.qkv_project(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tl.qkv_project(to_torch(p), torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("window,kv_block", [(None, 1024), (None, 4), (6, 4)])
def test_attention_torch_matches_attention_xla(window, kv_block):
    jcfg, tcfg = f32_pair("granite-3-8b", sliding_window=window)
    q, k, v = _qkv(5, 4, 2, 16)
    want = jl.attention_xla(*map(jnp.asarray, (q, k, v)), jcfg, kv_block=kv_block)
    got = tl.attention_torch(*map(torch.from_numpy, (q, k, v)), tcfg, kv_block=kv_block)
    assert_close(got, want)


@pytest.mark.parametrize("q_block", [8, 12])
def test_attention_banded(q_block):
    jcfg, tcfg = f32_pair("granite-3-8b", sliding_window=8)
    q, k, v = _qkv(6, 4, 2, 16, s=48)
    want = jl.attention_banded(*map(jnp.asarray, (q, k, v)), jcfg, q_block=q_block)
    got = tl.attention_banded(*map(torch.from_numpy, (q, k, v)), tcfg, q_block=q_block)
    assert_close(got, want)


@pytest.mark.parametrize(
    "window,length",
    [(None, 11), (None, np.array([3, 16])), (8, 13)],  # window 8 < cache 16: linear cache
)
def test_attention_decode(window, length):
    jcfg, tcfg = f32_pair("granite-3-8b", sliding_window=window)
    rng = np.random.default_rng(7)
    q = rand(rng, (B, 1, 4, 16))
    kc, vc = rand(rng, (B, S, 2, 16)), rand(rng, (B, S, 2, 16))
    want = jl.attention_decode(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(length), jcfg)
    t_len = torch.from_numpy(length) if isinstance(length, np.ndarray) else length
    got = tl.attention_decode(*map(torch.from_numpy, (q, kc, vc)), t_len, tcfg)
    assert_close(got, want)


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen1.5-110b"])
def test_run_attention_flash_matches_pallas_interpret(name):
    jcfg, tcfg = f32_pair(name)
    p = _attn_params(jcfg, 8)
    x = rand(np.random.default_rng(9), (B, S, jcfg.d_model))
    pos = np.arange(S)
    want = jl.run_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, jnp.asarray(pos), impl="pallas_interpret"
    )
    tp, tx, tpos = to_torch(p), torch.from_numpy(x), torch.from_numpy(pos)
    assert_close(tl.run_attention(tp, tx, tcfg, tpos, impl="kernel"), want)
    assert_close(tl.run_attention(tp, tx, tcfg, tpos, impl="torch"), want)


def test_run_attention_decode_writes_cache():
    jcfg, tcfg = f32_pair("granite-3-8b")
    p = _attn_params(jcfg, 10)
    rng = np.random.default_rng(11)
    x = rand(rng, (B, 1, jcfg.d_model))
    cache = {"k": rand(rng, (B, S, 2, 16)), "v": rand(rng, (B, S, 2, 16))}
    want_out, want_cache = jl.run_attention_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        jax.tree.map(jnp.asarray, cache), jnp.array(5),
    )
    t_cache = to_torch(cache)
    got = tl.run_attention_decode(to_torch(p), torch.from_numpy(x), tcfg, t_cache, 5)
    assert_close(got, want_out)
    for key in ("k", "v"):
        assert_close(t_cache[key], want_cache[key])


def test_run_attention_rejects_unknown_impl():
    jcfg, tcfg = f32_pair("granite-3-8b")
    p = to_torch(_attn_params(jcfg, 12))
    with pytest.raises(ValueError):
        tl.run_attention(p, torch.zeros(B, S, jcfg.d_model), tcfg, torch.arange(S), impl="pallas")
