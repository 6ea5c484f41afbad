"""Flash attention parity: the port's ``flash_attention`` on the CPU (its
plain PyTorch version) against the JAX package's Pallas kernel run in
interpret mode, on every case of the JAX kernel sweep (test_kernels.py),
with the same tolerances."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.attention.ops import flash_attention as jax_flash
from repro_torch.configs import all_archs
from repro_torch.kernels.attention import ops

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == jnp.bfloat16 else dict(atol=2e-4, rtol=2e-4)


def _inputs(seed, B, S, H, K, hd, dtype):
    """The same values in both frameworks: float32 normals from numpy, cast
    to ``dtype`` by each (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, S, n, hd), dtype=np.float32) for n in (H, K, K)]
    jax_in = [jnp.asarray(a).astype(dtype) for a in arrays]
    torch_in = [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]
    return jax_in, torch_in


def _compare(jax_in, torch_in, dtype, **kw):
    want = jax_flash(*jax_in, causal=True, interpret=True, **kw)
    before = ops.launches
    got = ops.flash_attention(*torch_in, causal=True, **kw)
    assert ops.launches == before  # the CPU path runs the plain version
    assert got.shape == torch_in[0].shape and got.dtype == torch_in[0].dtype
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **_tol(dtype)
    )


@pytest.mark.parametrize(
    "B,S,H,K,hd,blk",
    [
        (1, 128, 4, 4, 32, 64),  # MHA
        (2, 256, 4, 2, 64, 64),  # GQA 2:1
        (1, 256, 8, 2, 16, 128),  # GQA 4:1, small head dim
        (1, 64, 2, 1, 128, 32),  # MQA
    ],
)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_sweep(B, S, H, K, hd, blk, dtype):
    jax_in, torch_in = _inputs(0, B, S, H, K, hd, dtype)
    _compare(jax_in, torch_in, dtype, blk_q=blk, blk_k=blk)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_head_dim_192(dtype):
    """nemotron-4-340b's head dim, which the card takes in bf16."""
    jax_in, torch_in = _inputs(4, 1, 128, 4, 2, 192, dtype)
    _compare(jax_in, torch_in, dtype, blk_q=64, blk_k=64)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,K,hd",
    [
        (1, 256, 14, 2, 64),  # internvl2-1b's GQA 7:1 at its head dim (S cut from 768)
        (1, 128, 32, 32, 64),  # musicgen-large's MHA, 32 heads of 64 (S cut from 512)
    ],
)
def test_flash_attention_modality_shapes(B, S, H, K, hd, dtype):
    """The head layouts the modality configs give the kernel, which no
    sweep case had: 14 query heads over 2 KV heads, and 32 over 32."""
    jax_in, torch_in = _inputs(5, B, S, H, K, hd, dtype)
    _compare(jax_in, torch_in, dtype, blk_q=128, blk_k=128)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", sorted(all_archs()))
def test_every_config_head_dim_is_taken_by_the_bf16_kernel(name, reduced):
    """The serve path runs bf16, so the tensor-core kernel must take the
    head dim of every config the port serves, full width or reduced."""
    cfg = all_archs()[name]
    cfg = cfg.reduced() if reduced else cfg
    assert cfg.resolved_head_dim in ops.HEAD_DIMS[torch.bfloat16]


@pytest.mark.parametrize("window", [32, 96, 1024])
def test_flash_attention_sliding_window(window):
    jax_in, torch_in = _inputs(1, 1, 256, 4, 2, 32, jnp.float32)
    _compare(jax_in, torch_in, jnp.float32, window=window, blk_q=64, blk_k=64)


def test_flash_attention_asymmetric_blocks():
    jax_in, torch_in = _inputs(2, 1, 256, 2, 2, 32, jnp.float32)
    _compare(jax_in, torch_in, jnp.float32, blk_q=128, blk_k=32)


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(blk_q=48), ValueError),  # S % blk != 0
        (dict(window=0), ValueError),
    ],
)
def test_flash_attention_rejects_bad_arguments(kw, err):
    _, (q, k, v) = _inputs(3, 1, 64, 2, 1, 16, jnp.float32)
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)


def test_flash_attention_rejects_mismatched_dtypes():
    _, (q, k, v) = _inputs(3, 1, 64, 2, 1, 16, jnp.float32)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.to(torch.bfloat16), v)

