"""Flash attention parity: the port's ``flash_attention`` on the CPU (its
plain PyTorch version) against the JAX package's Pallas kernel run in
interpret mode, on every case of the JAX kernel sweep (test_kernels.py),
with the same tolerances.  The float32 CUDA kernel's arithmetic
(``ref.attention_split_tf32_reference``) is held against the same JAX
kernel and, at the MoE widths, against the float64 plain version."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.attention.ops import flash_attention as jax_flash
from repro_torch.configs import all_archs
from repro_torch.kernels.attention import ops, ref

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", sorted(all_archs()))
def test_every_config_head_dim_is_taken_by_both_kernels(name, reduced, dtype):
    """Each kernel takes the head dim of every config, full width or
    reduced: the float32 one too (nemotron-4-340b's 192 included), so no
    config's float32 attention is refused on the card."""
    cfg = all_archs()[name]
    cfg = cfg.reduced() if reduced else cfg
    assert cfg.resolved_head_dim in ops.HEAD_DIMS[dtype]


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



# The float32 CUDA kernel's arithmetic (ref.attention_split_tf32_reference:
# 64-row blocks, 32-key tiles, split-TF32 products) on the CPU.
MIRROR_SWEEP = [  # (B, S, H, K, hd, window), the float32 cases of the card's sweep
    (1, 128, 4, 4, 32, None),  # MHA
    (2, 256, 4, 2, 64, None),  # GQA 2:1
    (1, 256, 8, 2, 16, None),  # GQA 4:1, small head dim
    (1, 64, 2, 1, 128, None),  # MQA
    (1, 256, 4, 2, 32, 32),  # windows
    (1, 256, 4, 2, 32, 96),
    (1, 256, 4, 2, 32, 1024),
    (2, 12, 4, 2, 64, None),  # S = 12, not a multiple of 8
    (1, 128, 4, 4, 80, None),  # head dim 80
]
MOE_WIDTHS = (1, 512, 4, 1, 128)  # mixtral's head dim and prompt, few heads


def _mirror(torch_in, window, tf32="split", pv_tf32="split"):
    q, k, v = (t.transpose(1, 2) for t in torch_in)
    out = ref.attention_split_tf32_reference(q, k, v, window=window, tf32=tf32, pv_tf32=pv_tf32)
    return out.transpose(1, 2)


@pytest.mark.parametrize("B,S,H,K,hd,window", MIRROR_SWEEP)
def test_split_tf32_mirror_matches_jax_kernel(B, S, H, K, hd, window):
    """The kernel's tiles and split-TF32 products against the Pallas kernel
    in interpret mode, at 2e-4 + 2e-4 |want|."""
    jax_in, torch_in = _inputs(6, B, S, H, K, hd, jnp.float32)
    want = jax_flash(*jax_in, causal=True, window=window, blk_q=min(64, S), blk_k=min(64, S),
                     interpret=True)
    got = _mirror(torch_in, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def _share_out_of_tolerance(window, tf32="split", pv_tf32="split"):
    """Share of outputs of the mirror outside 2e-4 + 2e-4 |want| of the
    plain version in float64, at the MoE widths."""
    _, torch_in = _inputs(7, *MOE_WIDTHS, jnp.float32)
    want = ref.attention_reference(*(t.double().transpose(1, 2) for t in torch_in),
                                   window=window).transpose(1, 2)
    err = (_mirror(torch_in, window, tf32, pv_tf32).double() - want).abs()
    return float((err > 2e-4 + 2e-4 * want.abs()).double().mean())


@pytest.mark.parametrize("window", [4096, None])
def test_split_tf32_mirror_holds_at_moe_widths(window):
    """hd 128 and S = 512 (mixtral's window of 4096 and none): every output
    of the split-TF32 arithmetic within 2e-4 + 2e-4 |want| of float64."""
    assert _share_out_of_tolerance(window) == 0.0


def test_one_tf32_product_misses_at_moe_widths():
    """One TF32 product (hi.hi) in place of three misses 2e-4 there: the
    reason every product of the kernel is split."""
    assert _share_out_of_tolerance(4096, tf32="one", pv_tf32="one") > 0.05


@pytest.mark.parametrize("pv_tf32", ["split_no_hl", "split_no_lh"])
def test_dropping_a_pv_cross_term_misses_at_moe_widths(pv_tf32):
    """P lies in [0, 1], but dropping either cross term of P.V still puts
    outputs outside 2e-4: the kernel keeps all three."""
    assert _share_out_of_tolerance(4096, pv_tf32=pv_tf32) > 0.0


def test_plain_version_computes_in_float64_for_float64_inputs():
    """The yardstick of the card's float64 checks: float64 in, float64
    arithmetic and out, within float32 rounding of the float32 result."""
    _, torch_in = _inputs(8, 1, 64, 2, 1, 32, jnp.float32)
    q, k, v = (t.transpose(1, 2) for t in torch_in)
    out64 = ref.attention_reference(q.double(), k.double(), v.double())
    assert out64.dtype == torch.float64
    torch.testing.assert_close(out64.float(), ref.attention_reference(q, k, v),
                               atol=1e-5, rtol=1e-5)
