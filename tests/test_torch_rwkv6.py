"""RWKV6 parity: the port's plain version and ``rwkv6_mix``'s CPU path
against the JAX package's Pallas kernel in interpret mode, on the sweep and
the strong-decay case of ``tests/test_kernels.py`` (same tolerances), and
the port's chunked WKV against the JAX model's, with an initial state and
padding."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.rwkv6.ops import rwkv6_mix as jax_rwkv6_mix
from repro.models import rwkv as jr
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


def _compare(arrays, dtype, chunk, tol):
    r, k, v, lw, u = arrays
    j = lambda a: jnp.asarray(a).astype(dtype)
    want_o, want_st = jax_rwkv6_mix(j(r), j(k), j(v), jnp.asarray(lw), jnp.asarray(u),
                                    chunk=chunk, interpret=True)
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
    _compare(_inputs(3, B, S, H, P), dtype, chunk, tol)


def test_strong_decay_no_overflow():
    """logw = -5: the regime where the factorised form overflows."""
    _compare(_inputs(4, 1, 128, 2, 16, logw=-5.0), jnp.float32, 32, F32_TOL)


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
