"""Tests of the port's CUDA kernels on the card.  They import no JAX (the
machine with the card has none) and skip without a card: a CUDA kernel has
no CPU mode.  Run them there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.kernels.attention import ops, ref
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py:19-20

CASES = [  # (B, S, H, K, hd, blk_q, blk_k, window), the JAX kernel sweep
    (1, 128, 4, 4, 32, 64, 64, None),  # MHA
    (2, 256, 4, 2, 64, 64, 64, None),  # GQA 2:1
    (1, 256, 8, 2, 16, 128, 128, None),  # GQA 4:1, small head dim
    (1, 64, 2, 1, 128, 32, 32, None),  # MQA
    (1, 256, 4, 2, 32, 64, 64, 32),  # windows
    (1, 256, 4, 2, 32, 64, 64, 96),
    (1, 256, 4, 2, 32, 64, 64, 1024),
    (1, 256, 2, 2, 32, 128, 32, None),  # asymmetric blocks
    (2, 12, 4, 2, 64, 128, 128, None),  # blk = S = 12, not a multiple of 8
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, dtype, seed=0):
    B, S, H, K, hd = case[:5]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=gen, device="cuda").to(dtype) for n in (H, K, K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_kernel_matches_plain_version(cuda, case, dtype):
    q, k, v = _inputs(case, dtype)
    _, _, _, _, _, blk_q, blk_k, window = case
    before = ops.launches
    got = ops.flash_attention(q, k, v, window=window, blk_q=blk_q, blk_k=blk_k)
    assert ops.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == dtype and got.shape == q.shape
    want = ref.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=window
    ).transpose(1, 2)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _inputs((1, 64, 2, 1, 32), torch.float32)
    q_strided = torch.zeros(1, 2, 64, 32, device="cuda").transpose(1, 2)  # (B, S, H, hd) view
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q_strided, k, v)
    q48 = torch.zeros(1, 64, 2, 48, device="cuda")
    k48 = torch.zeros(1, 64, 1, 48, device="cuda")
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q48, k48, k48)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), v)


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen1.5-110b"])
def test_flash_prefill_matches_torch_path(cuda, name):
    """The model's forward through the kernel against its plain attention
    path, in float32 on the card."""
    cfg = dataclasses.replace(
        get_arch(name).reduced(), param_dtype="float32", activation_dtype="float32"
    )
    params = build_model(cfg).init(0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(device="cuda").manual_seed(1))
    before = ops.launches
    with torch.inference_mode():
        flash, _ = build_model(cfg, attn_impl="flash").forward(params, {"tokens": tokens})
        plain, _ = build_model(cfg).forward(params, {"tokens": tokens})
    assert ops.launches == before + cfg.n_layers
    torch.testing.assert_close(flash, plain, atol=2e-4, rtol=2e-4)
