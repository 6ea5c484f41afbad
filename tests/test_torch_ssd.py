"""SSD parity: the port's plain version and ``ssd_scan``'s CPU path against
the JAX package's Pallas kernel in interpret mode, on the sweep of
``tests/test_kernels.py`` (same tolerances) and at the CUDA kernel's edges,
and the port's Mamba2 chunked scan against the JAX model's, with an initial
state and padding."""

import pytest

torch = pytest.importorskip("torch")

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro.models import mamba2 as jm
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models import mamba2 as tm
from torch_parity import BF16_TOL, F32_TOL, assert_close, rand

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the bounds it prints; it imports torch only when run)

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SWEEP = [  # (B, S, H, P, G, N, chunk), tests/test_kernels.py:110-118
    (1, 64, 2, 16, 1, 8, 16),
    (2, 128, 4, 16, 2, 8, 32),  # grouped B/C
    (1, 128, 4, 32, 1, 16, 64),
    (1, 256, 8, 16, 4, 8, 32),
]
KERNEL_EDGES = [  # (B, S, H, P, G, N, chunk): shapes at the CUDA kernel's edges
    (2, 128, 12, 16, 2, 8, 32),  # G > 1, six heads a group: a unit of five heads, then one
    (1, 64, 7, 16, 1, 16, 32),  # H not a multiple of the unit's five heads
    (1, 96, 2, 18, 1, 10, 32),  # P, N not multiples of 4 (the kernel's input is padded)
    (1, 256, 2, 16, 1, 8, 256),  # a chunk above 128 (the kernel runs 64-step chunks)
]


def _inputs(seed, B, S, H, P, G, N):
    """float32 numpy inputs drawn as the JAX sweep draws them: dt =
    softplus(normal), A = -exp(normal)."""
    rng = np.random.default_rng(seed)
    xh = rand(rng, (B, S, H, P))
    dt = np.logaddexp(rand(rng, (B, S, H)), 0.0).astype(np.float32)
    A = -np.exp(rand(rng, (H,)))
    bm = rand(rng, (B, S, G, N))
    cm = rand(rng, (B, S, G, N))
    return xh, dt, A, bm, cm


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", SWEEP + KERNEL_EDGES)
def test_plain_version_and_wrapper_match_jax_kernel(case, dtype):
    B, S, H, P, G, N, chunk = case
    xh, dt, A, bm, cm = _inputs(0, B, S, H, P, G, N)
    j = lambda a: jnp.asarray(a).astype(dtype)
    want_y, want_st = jax_ssd_scan(j(xh), jnp.asarray(dt), jnp.asarray(A), j(bm), j(cm),
                                   chunk=chunk, interpret=True)
    tdt = TORCH_DTYPES[dtype]
    t = lambda a: torch.from_numpy(a).to(tdt)
    tol = BF16_TOL if dtype == jnp.bfloat16 else F32_TOL

    before = ops.launches
    y, st = ops.ssd_scan(t(xh), torch.from_numpy(dt), torch.from_numpy(A), t(bm), t(cm), chunk=chunk)
    assert ops.launches == before  # the CPU path runs the plain version
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32 and st.shape == (B, H, N, P)
    assert_close(y, want_y, tol)
    assert_close(st, want_st, tol)

    # the plain version itself, head-major, as chip_smoke.py calls it
    dtf = torch.from_numpy(dt)
    xw = (t(xh).float() * dtf[..., None]).transpose(1, 2)
    la = (dtf * torch.from_numpy(A)).transpose(1, 2)[..., None]
    y_ref, st_ref = ref.ssd_reference(xw, la, t(bm).transpose(1, 2), t(cm).transpose(1, 2))
    assert_close(y_ref.transpose(1, 2), want_y, tol)
    assert_close(st_ref, want_st, tol)


def test_kernel_switch_matches_model_chunked_path():
    """The model's kernel route (zero state) agrees with its chunked path,
    and both with the JAX chunked path (tests/test_kernels.py:138-151)."""
    B, S, H, P, G, N = 1, 64, 2, 16, 1, 8
    xh, dt, A, bm, cm = _inputs(6, B, S, H, P, G, N)
    zero = np.zeros((B, H, N, P), np.float32)
    want, _ = jm.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, bm, cm, zero)), 16)
    args = [torch.from_numpy(a) for a in (xh, dt, A, bm, cm)]
    y_kernel, st_kernel = tm._ssd_kernel(*args, 16)
    y_torch, st_torch = tm.ssd_chunked(*args, torch.from_numpy(zero), 16)
    assert_close(y_kernel, y_torch)
    assert_close(st_kernel, st_torch)
    assert_close(y_kernel, want)


@pytest.mark.parametrize("S,chunk", [(50, 16), (37, 8), (5, 8)])
def test_ssd_chunked_with_state_and_padding_matches_jax(S, chunk):
    B, H, P, G, N = 2, 4, 8, 2, 4
    xh, dt, A, bm, cm = _inputs(7, B, S, H, P, G, N)
    state0 = rand(np.random.default_rng(8), (B, H, N, P), 0.5)
    want_y, want_st = jm.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, bm, cm, state0)), chunk)
    args = [torch.from_numpy(a) for a in (xh, dt, A, bm, cm, state0)]
    y, st = tm.ssd_chunked(*args, chunk)
    assert_close(y, want_y)
    assert_close(st, want_st)
    # and the sequential oracle of both packages
    oy, ost = tm.reference_ssd(*args)
    jy, jst = jm.reference_ssd(*(jnp.asarray(a) for a in (xh, dt, A, bm, cm, state0)))
    assert_close(oy, jy)
    assert_close(ost, jst)
    assert_close(y, oy)


def test_kernel_route_pads_to_the_chunk():
    """S = 45 is no multiple of the chunk: the route pads with dt=0 steps,
    which leave the state as it was."""
    B, S, H, P, G, N = 1, 45, 2, 8, 1, 4
    xh, dt, A, bm, cm = _inputs(9, B, S, H, P, G, N)
    args = [torch.from_numpy(a) for a in (xh, dt, A, bm, cm)]
    y, st = tm._ssd_kernel(*args, 16)
    want_y, want_st = tm.reference_ssd(*args, torch.zeros(B, H, N, P))
    assert y.shape == (B, S, H, P)
    assert_close(y, want_y)
    assert_close(st, want_st)


@pytest.mark.parametrize(
    "change,err",
    [
        (dict(chunk=24), ValueError),  # 64 % 24 != 0
        (dict(dt_dtype=torch.float16), TypeError),
        (dict(A_len=3), ValueError),
    ],
)
def test_ssd_scan_rejects_bad_arguments(change, err):
    xh, dt, A, bm, cm = (torch.from_numpy(a) for a in _inputs(10, 1, 64, 2, 8, 1, 4))
    if "dt_dtype" in change:
        dt = dt.to(change["dt_dtype"])
    if "A_len" in change:
        A = torch.zeros(change["A_len"])
    with pytest.raises(err):
        ops.ssd_scan(xh, dt, A, bm, cm, chunk=change.get("chunk", 16))


def test_kernel_inputs_cast_pad_and_keep_strides():
    """What the wrapper hands the CUDA kernel: float32, head and state dims
    padded with zeros to multiples of 4, and the model's strides where TMA
    can take them (no copy), a packed copy where it cannot."""
    x = torch.randn(2, 64, 3, 18, dtype=torch.bfloat16)
    b = torch.randn(2, 64, 1, 10)
    x4, b4, c4 = ops.kernel_inputs(x, b, b)
    assert x4.dtype == torch.float32 and x4.shape == (2, 64, 3, 20)
    assert torch.equal(x4[..., :18], x.float()) and not x4[..., 18:].any()
    assert b4.shape == c4.shape == (2, 64, 1, 12) and not b4[..., 10:].any()
    wide = torch.randn(2, 64, 56)  # a row of a larger projection: seq stride 56
    xs = wide[..., :48].reshape(2, 64, 3, 16)
    x4, _, _ = ops.kernel_inputs(xs, b, b)
    assert x4.data_ptr() == xs.data_ptr() and x4.stride() == xs.stride()
    odd = torch.randn(2, 64, 50)[..., :48].reshape(2, 64, 3, 16)  # seq stride 50: no 16-byte rows
    x4, _, _ = ops.kernel_inputs(odd, b, b)
    assert x4.is_contiguous() and torch.equal(x4, odd)


def test_ssd_bounds_at_zamba2_serve_shape():
    """chip_smoke.py's two bounds for K2 at zamba2-2.7b's prefill (B=8,
    S=512, H=80, P=64, G=1, N=64, float32): the least operations at the
    float32 FMA rate, and on the tensor cores (three TF32 products each),
    where the kernel runs and the 182 MB that the function moves bound it."""
    ms, by = chip_smoke.ssd_bound_ms(chip_smoke.ZAMBA_SSD, 4)
    assert by == "operations" and ms == pytest.approx(0.0879, abs=5e-5)
    ms, by = chip_smoke.ssd_tc_bound_ms(chip_smoke.ZAMBA_SSD, 4)
    assert by == "bytes" and ms == pytest.approx(0.0542, abs=5e-5)
