"""The training path of flash attention on the CPU: the plain backward in
``kernels/attention/ref.py`` (the arithmetic of ``csrc/flash_bwd_sm90.cu``)
against autograd through ``layers.attention_torch`` and against ``jax.grad``
of the JAX package's ``attention_xla``, its hi/lo split of dS,
the autograd function of ``ops.py`` on its plain versions, and the rule by
which ``layers.run_attention`` routes the ``torch`` path's attention.  The
kernels themselves are held against the same functions on the card
(``tests/test_torch_cuda.py``)."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.kernels.attention import ops, ref
from repro_torch.models import layers

CFG = dataclasses.replace(get_arch("granite-3-8b").reduced(), sliding_window=None)


def _inputs(seed, B, S, H, K, hd, dtype):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen, dtype=torch.float64).to(dtype) for n in (H, K, K))
    dout = torch.randn(B, S, H, hd, generator=gen, dtype=torch.float64).to(dtype)
    return q, k, v, dout


def _torch_path_grads(q, k, v, dout, kv_block=32):
    """(out, dq, dk, dv) by autograd through the torch path's attention."""
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = layers.attention_torch(q, k, v, CFG, kv_block=kv_block)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))


def _plain_grads(q, k, v, dout, blk=32):
    """(out, dq, dk, dv) of the plain forward with statistics and the plain
    backward, in the model's (B, S, heads, hd) layout."""
    hm = [t.transpose(1, 2) for t in (q, k, v)]
    out, lse = ref.attention_stats_reference(*hm, blk=48)
    grads = ref.attention_backward_reference(*hm, out, lse, dout.transpose(1, 2), blk=blk)
    return (out.transpose(1, 2), *(g.transpose(1, 2) for g in grads))


def _worst(got, want):
    """The largest difference over the largest magnitude of the reference."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "B,S,H,K,hd",
    [
        (1, 64, 4, 1, 64),  # GQA 4:1
        (2, 96, 4, 4, 64),  # MHA, S not a multiple of the blocks
        (1, 128, 8, 2, 128),  # GQA 4:1 at granite's head dim
        (1, 200, 4, 4, 128),  # MHA at hd 128, ragged blocks
        (2, 40, 8, 2, 64),  # a sequence below one block
    ],
)
def test_plain_backward_matches_autograd_of_the_torch_path(B, S, H, K, hd, dtype):
    """Float32 and float64 inputs keep every operand, so the plain backward
    is the exact blocked gradient: it agrees with autograd through
    ``attention_torch`` (which computes in float32 whatever the inputs)
    within float32 summation noise, output, dq, dk and dv alike."""
    q, k, v, dout = _inputs(0, B, S, H, K, hd, dtype)
    want = _torch_path_grads(q, k, v, dout)
    got = _plain_grads(q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert _worst(g, w) < 2e-6, (name, _worst(g, w))


@pytest.mark.parametrize(
    "B,S,H,K,hd",
    [
        (1, 200, 8, 2, 64),  # GQA 4:1, S not a multiple of 128
        (2, 72, 4, 4, 128),  # MHA at granite's head dim
        (1, 130, 4, 1, 128),  # GQA 4:1 at hd 128, one row past a 128-row tile
    ],
)
def test_plain_backward_matches_jax_grad_of_attention_xla(B, S, H, K, hd):
    """The gradient the JAX trainer takes, ``jax.grad`` of the JAX
    package's ``attention_xla`` on the same float32 inputs, against the
    plain backward and against ``FlashAttention`` (its CPU path), within
    float32 summation noise."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_arch as jax_get_arch
    from repro.models.layers import attention_xla

    jcfg = dataclasses.replace(jax_get_arch("granite-3-8b").reduced(), sliding_window=None)
    q, k, v, dout = _inputs(8, B, S, H, K, hd, torch.float32)
    jq, jk, jv, jdout = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
    objective = lambda a, b, c: jnp.sum(attention_xla(a, b, c, jcfg, kv_block=64) * jdout)
    want = [torch.from_numpy(np.array(g)) for g in jax.jit(jax.grad(objective, argnums=(0, 1, 2)))(jq, jk, jv)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    function = torch.autograd.grad(ops.flash_attention_trainable(*leaves), leaves, dout)
    for name, plain, fn, w in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, dout)[1:], function, want):
        assert _worst(plain, w) < 2e-6, (name, _worst(plain, w))
        assert _worst(fn, w) < 2e-6, (name, _worst(fn, w))


def test_plain_backward_does_not_depend_on_the_block():
    q, k, v, dout = _inputs(1, 1, 160, 4, 2, 64, torch.float64)
    a = _plain_grads(q, k, v, dout, blk=16)
    b = _plain_grads(q, k, v, dout, blk=160)
    for x, y in zip(a[1:], b[1:]):
        assert _worst(x, y) < 1e-12


def test_stats_reference_log_sum_exp_is_the_causal_rows():
    q, k, v, _ = _inputs(2, 2, 72, 4, 2, 64, torch.float64)
    hm = [t.transpose(1, 2) for t in (q, k, v)]
    out, lse = ref.attention_stats_reference(*hm, blk=32)
    scores = hm[0] @ hm[1].repeat_interleave(2, dim=1).transpose(-1, -2) / 8.0
    causal = torch.ones(72, 72, dtype=torch.bool).tril()
    want = torch.logsumexp(scores.masked_fill(~causal, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(out, ref.attention_reference(*hm), atol=1e-12, rtol=1e-12)


def test_hi_lo_split_keeps_16_bits_of_ds():
    """dS as bf16 hi + bf16 lo is within 2^-15 of float32 dS per element,
    and so are the products dS.K it enters, per element against the sum of
    the magnitudes of their terms."""
    gen = torch.Generator().manual_seed(3)
    ds = torch.randn(64, 96, generator=gen) * torch.exp2(torch.randint(-20, 4, (64, 96), generator=gen).float())
    k = torch.randn(96, 128, generator=gen).to(torch.bfloat16)
    hi, lo = ref.split_hi_lo(ds, torch.bfloat16)
    assert hi.dtype == lo.dtype == torch.bfloat16
    pair = hi.double() + lo.double()
    assert bool(((pair - ds.double()).abs() <= 2.0 ** -15 * ds.double().abs()).all())
    assert float(((hi.double() - ds.double()).abs() / ds.double().abs()).max()) > 2.0 ** -15  # hi alone is not
    prod = hi.float() @ k.float() + lo.float() @ k.float()
    want = ds.double() @ k.double()
    bound = ds.double().abs() @ k.double().abs()
    assert bool(((prod.double() - want).abs() <= 2.0 ** -15 * bound).all())
    for exact in (torch.float32, torch.float64):
        h, l = ref.split_hi_lo(ds.to(exact), exact)
        assert torch.equal(h, ds.to(exact)) and not l.any()


def test_plain_bf16_backward_is_no_coarser_than_the_torch_path():
    """In bf16 the plain backward (the kernels' arithmetic: P rounded for
    dV, dS as hi + lo) lies closer to the float64 gradient than autograd
    through ``attention_torch`` in bf16 does (that path rounds dP to bf16)."""
    q, k, v, dout = _inputs(4, 1, 192, 8, 2, 128, torch.bfloat16)
    exact = _plain_grads(*(t.double() for t in (q, k, v, dout)))
    plain = _plain_grads(q, k, v, dout)
    torch_path = _torch_path_grads(q, k, v, dout, kv_block=64)
    for name, p, t, e in zip(("dq", "dk", "dv"), plain[1:], torch_path[1:], exact[1:]):
        rel = lambda x: float((x.double() - e).norm() / e.norm())
        assert rel(p) <= rel(t), (name, rel(p), rel(t))
        assert rel(p) < 5e-3, (name, rel(p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_autograd_function_on_the_cpu_runs_the_plain_versions(dtype):
    """``flash_attention_trainable`` under autograd is ``FlashAttention``:
    on the CPU its gradients are the plain backward's, and no kernel launch
    is counted.  Without autograd it is ``flash_attention`` (its plain
    version here), whatever S."""
    q, k, v, dout = _inputs(5, 2, 80, 4, 2, 64, dtype)
    before = (ops.launches, ops.stats_launches, ops.backward_launches)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention_trainable(qq, kk, vv)
    assert out.grad_fn is not None and out.shape == q.shape and out.dtype == dtype
    grads = torch.autograd.grad(out, (qq, kk, vv), dout)
    want = _plain_grads(q, k, v, dout)
    torch.testing.assert_close(out, want[0], atol=0, rtol=0)
    for g, w in zip(grads, want[1:]):
        torch.testing.assert_close(g, w, atol=1e-12 if dtype == torch.float64 else 1e-6, rtol=1e-6)
    with torch.no_grad():
        plain = ops.flash_attention_trainable(q, k, v)
        torch.testing.assert_close(plain, ops.flash_attention(q, k, v, blk_q=80, blk_k=80), atol=0, rtol=0)
    torch.testing.assert_close(plain, want[0], atol=1e-12 if dtype == torch.float64 else 1e-6, rtol=1e-6)
    assert (ops.launches, ops.stats_launches, ops.backward_launches) == before


def test_autograd_function_passes_gradcheck():
    q, k, v, _ = _inputs(6, 1, 12, 2, 1, 8, torch.float64)
    args = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(ops.flash_attention_trainable, args)


def test_autograd_function_under_block_remat_matches_autograd():
    """Recomputed inside the backward pass (non-reentrant checkpoint, as
    block remat runs a layer), the function gives the same gradients."""
    q, k, v, dout = _inputs(7, 1, 64, 4, 2, 64, torch.float64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.utils.checkpoint.checkpoint(ops.flash_attention_trainable, *leaves, use_reentrant=False)
    got = torch.autograd.grad(out, leaves, dout)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention_trainable(*leaves), leaves, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def _like(device="cuda", dtype=torch.bfloat16, S=64, hd=128, placements=False):
    """A stand-in for a (1, S, 4, hd) tensor: what the routing rule reads."""
    t = types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(1, S, 4, hd))
    if placements:
        t.placements = ()
    return t


@pytest.mark.parametrize(
    "q,window,takes",
    [
        (_like(), None, True),  # bf16 on the card at hd 128
        (_like(hd=64), None, True),
        (_like(hd=80), None, True),  # zamba2's shared block
        (_like(hd=128), 64, True),  # a window that does not bind (S <= window)
        (_like(device="cpu"), None, False),  # the CPU keeps the plain reference
        (_like(placements=True), None, False),  # the dry-run's DTensors
        (_like(dtype=torch.float32), None, False),  # float32 MoE attention
        (_like(hd=192), None, False),  # a head dim the backward does not take
        (_like(hd=16), None, False),
        (_like(S=96), 64, False),  # a binding window
    ],
)
def test_routing_rule_reads_device_dtype_head_dim_and_window(q, window, takes):
    cfg = dataclasses.replace(CFG, sliding_window=window)
    assert layers.takes_flash_backward(q, q, q, cfg) is takes


def test_run_attention_routes_by_the_rule(monkeypatch):
    """On CPU tensors the ``torch`` path runs ``attention_torch``; where the
    rule holds (forced here, as no card is present) it runs the autograd
    function instead, with the same q, k and v."""
    from repro_torch.kernels.attention import ops as flash_ops

    cfg = dataclasses.replace(CFG, head_dim=64)
    calls = []
    real = layers.attention_torch

    def torch_path(q, k, v, c, *a, **kw):
        calls.append("torch")
        return real(q, k, v, c, *a, **kw)

    def trainable(q, k, v):
        calls.append(("flash", q.shape, k.shape, v.shape))
        return real(q, k, v, cfg)

    monkeypatch.setattr(layers, "attention_torch", torch_path)
    monkeypatch.setattr(flash_ops, "flash_attention_trainable", trainable)
    model_params = _block_attention(cfg)
    x = torch.randn(2, 16, cfg.d_model, dtype=torch.bfloat16)
    pos = torch.arange(16)
    layers.run_attention(model_params, x, cfg, pos, impl="torch")
    assert calls == ["torch"]
    monkeypatch.setattr(layers, "takes_flash_backward", lambda q, k, v, c: True)
    calls.clear()
    layers.run_attention(model_params, x, cfg, pos, impl="torch")
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert calls == [("flash", (2, 16, H, hd), (2, 16, K, hd), (2, 16, K, hd))]


def _block_attention(cfg):
    """One layer's attention parameters of a model built from ``cfg``."""
    from repro_torch.models import build_model

    layers_p = build_model(cfg).init(0, device="cpu")["layers"]
    return {name: t[0] for name, t in layers_p["attn"].items()}
