"""RWKV6 parity: the port's plain version and ``rwkv6_mix``'s CPU path
against the JAX package's Pallas kernel in interpret mode, on the sweep and
the strong-decay case of ``tests/test_kernels.py`` (same tolerances), and
the port's chunked WKV against the JAX model's, with an initial state and
padding.  The CUDA kernel's decomposition (``ref.rwkv6_subchunk_reference``:
sub-chunk anchoring, split-TF32 products) is held against the same JAX
kernel and, at rwkv6's widths, against the float64 plain version."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.rwkv6.ops import rwkv6_mix as jax_rwkv6_mix
from repro.models import rwkv as jr
from repro_torch.configs import get_arch
from repro_torch.kernels.tf32 import split, tf32_rna
from repro_torch.kernels.rwkv6 import ops, ref
from repro_torch.models import rwkv as tr
from torch_parity import BF16_TOL, F32_TOL, assert_close, rand

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SWEEP = [(1, 64, 2, 16, 16), (2, 128, 3, 16, 32), (1, 96, 1, 32, 32), (1, 32, 2, 8, 32)]


def _inputs(seed, B, S, H, P, logw=None):
    """float32 numpy inputs drawn as the JAX sweep draws them: logw =
    -exp(normal - 1), u = 0.1 normal; or a constant ``logw``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rand(rng, (B, S, H, P)) for _ in range(3))
    if logw is None:
        lw = -np.exp(rand(rng, (B, S, H, P)) - 1.0)
    else:
        lw = np.full((B, S, H, P), logw, np.float32)
    u = rand(rng, (H, P), 0.1)
    return r, k, v, lw, u


_JAX_OUTPUTS = {}


def _jax_kernel(arrays, dtype, chunk, key):
    """The Pallas kernel in interpret mode on ``arrays`` (r, k, v in
    ``dtype``), computed once per ``key``: the plain-version and mirror tests
    of a case share it."""
    key = (*key, jnp.dtype(dtype).name, chunk)
    if key not in _JAX_OUTPUTS:
        r, k, v, lw, u = arrays
        j = lambda a: jnp.asarray(a).astype(dtype)
        _JAX_OUTPUTS[key] = jax_rwkv6_mix(j(r), j(k), j(v), jnp.asarray(lw), jnp.asarray(u),
                                          chunk=chunk, interpret=True)
    return _JAX_OUTPUTS[key]


def _compare(arrays, dtype, chunk, tol, key):
    r, k, v, lw, u = arrays
    want_o, want_st = _jax_kernel(arrays, dtype, chunk, key)
    tdt = TORCH_DTYPES[dtype]
    t = lambda a: torch.from_numpy(a).to(tdt)
    before = ops.launches
    out, st = ops.rwkv6_mix(t(r), t(k), t(v), torch.from_numpy(lw), torch.from_numpy(u), chunk=chunk)
    assert ops.launches == before  # the CPU path runs the plain version
    assert out.dtype == torch.float32 and out.shape == r.shape
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    assert_close(out, want_o, tol)
    assert_close(st, want_st, tol)
    # the plain version itself, head-major, as chip_smoke.py calls it
    hm = lambda a: a.transpose(1, 2)
    o_ref, st_ref = ref.rwkv6_reference(hm(t(r)), hm(t(k)), hm(t(v)), hm(torch.from_numpy(lw)),
                                        torch.from_numpy(u))
    assert_close(hm(o_ref), want_o, tol)
    assert_close(st_ref, want_st, tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,P,chunk", SWEEP)
def test_plain_version_and_wrapper_match_jax_kernel(B, S, H, P, chunk, dtype):
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    _compare(_inputs(3, B, S, H, P), dtype, chunk, tol, key=(3, B, S, H, P))


def test_strong_decay_no_overflow():
    """logw = -5: the regime where the factorised form overflows."""
    _compare(_inputs(4, 1, 128, 2, 16, logw=-5.0), jnp.float32, 32, F32_TOL,
             key=(4, 1, 128, 2, 16, -5.0))


def _mirror(arrays, dtype, sub, tf32="split"):
    """The kernel's decomposition on numpy model-layout inputs (r, k, v in
    ``dtype``), in the model layout."""
    r, k, v, lw, u = arrays
    tdt = TORCH_DTYPES[dtype]
    hm = lambda a, t=torch.float32: torch.from_numpy(a).to(t).transpose(1, 2)
    out, st = ref.rwkv6_subchunk_reference(hm(r, tdt), hm(k, tdt), hm(v, tdt), hm(lw),
                                           torch.from_numpy(u), sub=sub, tf32=tf32)
    return out.transpose(1, 2), st


@pytest.mark.parametrize("sub", [16, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,P,chunk", SWEEP)
def test_subchunk_mirror_matches_jax_kernel(B, S, H, P, chunk, dtype, sub):
    """The CUDA kernel's decomposition (64-step chunks, anchored
    off-diagonal blocks, direct diagonal blocks, split-TF32 products,
    zero-fill past S) against the Pallas kernel on the JAX sweep."""
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL
    arrays = _inputs(3, B, S, H, P)
    want_o, want_st = _jax_kernel(arrays, dtype, chunk, key=(3, B, S, H, P))
    out, st = _mirror(arrays, dtype, sub)
    assert out.shape == (B, S, H, P) and st.shape == (B, H, P, P)
    assert_close(out, want_o, tol)
    assert_close(st, want_st, tol)


@pytest.mark.parametrize("sub", [16, 8])
def test_subchunk_mirror_strong_decay(sub):
    """logw = -5 (tests/test_kernels.py:92-104): every exponent of the
    decomposition stays <= 0, so nothing overflows."""
    arrays = _inputs(4, 1, 128, 2, 16, logw=-5.0)
    want_o, want_st = _jax_kernel(arrays, jnp.float32, 32, key=(4, 1, 128, 2, 16, -5.0))
    out, st = _mirror(arrays, jnp.float32, sub)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    assert_close(out, want_o, F32_TOL)
    assert_close(st, want_st, F32_TOL)


def _against_float64(arrays, sub, tf32):
    """(max |err|, share of elements outside 2e-4 + 2e-4 |want|) of the
    mirror against the float64 plain version, over the output and state."""
    got = _mirror(arrays, jnp.float32, sub, tf32)
    hm = lambda a: torch.from_numpy(a).double().transpose(1, 2)
    r, k, v, lw, u = arrays
    o64, st64 = ref.rwkv6_reference(hm(r), hm(k), hm(v), hm(lw), torch.from_numpy(u).double())
    errs, bad, total = [], 0, 0
    for g, w in zip(got, (o64.transpose(1, 2), st64)):
        e = (g.double() - w).abs()
        errs.append(float(e.max()))
        bad += int((e > 2e-4 + 2e-4 * w.abs()).sum())
        total += e.numel()
    return max(errs), bad / total


@pytest.mark.parametrize("sub", [16, 8])
@pytest.mark.parametrize("logw", [None, -5.0])
def test_subchunk_split_tf32_holds_at_rwkv6_widths(logw, sub):
    """At rwkv6's widths (P = 64, S = 512: eight 64-step chunks) the
    split-TF32 decomposition keeps every element within 2e-4 + 2e-4 |want|
    of the float64 plain version."""
    _, share = _against_float64(_inputs(10, 1, 512, 2, 64, logw), sub, "split")
    assert share == 0.0


def test_subchunk_one_tf32_product_misses_at_rwkv6_widths():
    """One TF32 product (hi.hi) in place of three does not hold 2e-4 there:
    the reason every product of the kernel is split."""
    _, share = _against_float64(_inputs(10, 1, 512, 2, 64), 16, "one")
    assert share > 0.5


def test_tf32_split_parts():
    """hi clears the low 13 mantissa bits; lo = tf32(x - hi) rounds half
    away from zero; hi + lo is x to about 2^-22 relative."""
    x = torch.from_numpy(rand(np.random.default_rng(11), (4096,)))
    hi, lo = split(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - x).abs() <= 2.0**-21 * x.abs()).all()
    assert tf32_rna(torch.tensor([1.0 + 2.0**-11])).item() == 1.0 + 2.0**-10  # a tie, away


@pytest.mark.parametrize("P,dtype,P_kernel", [(16, torch.float32, 16), (18, torch.float32, 20),
                                               (18, torch.bfloat16, 24), (64, torch.bfloat16, 64)])
def test_kernel_inputs_pad_the_head_dim_only_when_tma_needs_it(P, dtype, P_kernel):
    """TMA's 16-byte strides: a head dim that is a multiple of 4 (float32) or
    8 (bfloat16) goes to the kernel as it is; another is padded with zeros."""
    r, k, v, lw, u = (torch.from_numpy(a) for a in _inputs(12, 1, 32, 2, P))
    r, k, v = (t.to(dtype) for t in (r, k, v))
    got = ops.kernel_inputs(r, k, v, lw, u)
    assert [t.shape[-1] for t in got] == [P_kernel] * 5
    assert [t.dtype for t in got] == [dtype] * 3 + [torch.float32] * 2
    if P_kernel == P:
        assert got[0].data_ptr() == r.data_ptr()  # no copy
    else:
        assert (got[0][..., P:] == 0).all() and torch.equal(got[0][..., :P], r)


def test_kernel_switch_matches_model_chunked_path():
    B, S, H, P = 2, 64, 2, 16
    r, k, v, lw, u = _inputs(5, B, S, H, P)
    zero = np.zeros((B, H, P, P), np.float32)
    want, _ = jr._chunked_wkv(*(jnp.asarray(a) for a in (r, k, v, lw, u, zero)), 32)
    args = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    o_kernel, st_kernel = tr._wkv_kernel(*args, 32)
    o_torch, st_torch = tr._chunked_wkv(*args, torch.from_numpy(zero), 32)
    assert_close(o_kernel, o_torch)
    assert_close(st_kernel, st_torch)
    assert_close(o_kernel, want)


@pytest.mark.parametrize("S,chunk", [(50, 16), (37, 32), (5, 8)])
def test_chunked_wkv_with_state_and_padding_matches_jax(S, chunk):
    B, H, P = 2, 3, 8
    r, k, v, lw, u = _inputs(6, B, S, H, P)
    state0 = rand(np.random.default_rng(7), (B, H, P, P), 0.5)
    jargs = [jnp.asarray(a) for a in (r, k, v, lw, u, state0)]
    want_o, want_st = jr._chunked_wkv(*jargs, chunk)
    args = [torch.from_numpy(a) for a in (r, k, v, lw, u, state0)]
    out, st = tr._chunked_wkv(*args, chunk)
    assert_close(out, want_o)
    assert_close(st, want_st)
    # and the sequential oracle of both packages
    oo, ost = tr.reference_wkv(*args)
    jo, jst = jr.reference_wkv(*jargs)
    assert_close(oo, jo)
    assert_close(ost, jst)
    assert_close(out, oo)


def test_kernel_route_pads_to_the_chunk():
    """S = 45 is no multiple of the chunk: the route pads with logw=0 and
    zero r/k/v, which leave the state as it was."""
    B, S, H, P = 1, 45, 2, 8
    r, k, v, lw, u = (torch.from_numpy(a) for a in _inputs(8, B, S, H, P))
    out, st = tr._wkv_kernel(r, k, v, lw, u, 32)
    want_o, want_st = tr.reference_wkv(r, k, v, lw, u, torch.zeros(B, H, P, P))
    assert out.shape == (B, S, H, P)
    assert_close(out, want_o)
    assert_close(st, want_st)


def _time_mix_setup(dtype, S, seed=0):
    cfg = get_arch("rwkv6-3b").reduced()
    gen = torch.Generator().manual_seed(seed)
    p = tr.init_time_mix(gen, cfg, dtype, "cpu")
    x = torch.randn(2, S, cfg.d_model, generator=gen).to(dtype)
    return p, x, cfg, torch.zeros(2, cfg.d_model, dtype=dtype)


def test_time_mix_kernel_route_feeds_bf16_unchanged(monkeypatch):
    """With bfloat16 activations the kernel route hands r, k, v to the scan
    in bfloat16 (logw in float32); bfloat16 converts to float32 exactly, so
    the result is bit-for-bit that of the float32-cast call."""
    p, x, cfg, prev = _time_mix_setup(torch.bfloat16, 64)
    real = tr._wkv_kernel
    seen = []

    def spy(r, k, v, logw, u, chunk):
        seen.append((r.dtype, k.dtype, v.dtype, logw.dtype))
        return real(r, k, v, logw, u, chunk)

    monkeypatch.setattr(tr, "_wkv_kernel", spy)
    out, st, _ = tr.apply_time_mix(p, x, cfg, prev, None, 32, impl="kernel")
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32)]
    monkeypatch.setattr(tr, "_wkv_kernel", lambda r, k, v, logw, u, chunk: real(
        r.float(), k.float(), v.float(), logw, u, chunk))
    out32, st32, _ = tr.apply_time_mix(p, x, cfg, prev, None, 32, impl="kernel")
    assert torch.equal(out, out32)
    assert torch.equal(st, st32)


def test_time_mix_kernel_route_takes_chunk_128():
    """``apply_time_mix``'s default chunk (128) goes through the kernel
    route: the scan takes any chunk that divides the (padded) sequence."""
    p, x, cfg, prev = _time_mix_setup(torch.float32, 256, seed=1)
    out_k, st_k, _ = tr.apply_time_mix(p, x, cfg, prev, None, impl="kernel")
    out_t, st_t, _ = tr.apply_time_mix(p, x, cfg, prev, None, impl="torch")
    assert_close(out_k, out_t)
    assert_close(st_k, st_t)


@pytest.mark.parametrize(
    "change,err",
    [
        (dict(chunk=24), ValueError),  # 64 % 24 != 0
        (dict(u_shape=(3, 8)), ValueError),
        (dict(r_dtype=torch.float16), TypeError),
    ],
)
def test_rwkv6_mix_rejects_bad_arguments(change, err):
    r, k, v, lw, u = (torch.from_numpy(a) for a in _inputs(9, 1, 64, 2, 8))
    if "u_shape" in change:
        u = torch.zeros(change["u_shape"])
    if "r_dtype" in change:
        r = r.to(change["r_dtype"])
    with pytest.raises(err):
        ops.rwkv6_mix(r, k, v, lw, u, chunk=change.get("chunk", 16))
