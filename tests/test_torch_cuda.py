"""Tests of the port's CUDA kernels, and of its network passes, on the
card.  They import no JAX (the machine with the card has none) and skip
without a card: a CUDA kernel has no CPU mode, and the network passes are
held here against their own CPU path.  Run them there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.kernels.attention import ops, ref
from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
from repro_torch.kernels.rwkv6 import ref as rwkv6_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import build_model
from repro_torch import network as net

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
    (1, 128, 4, 4, 80, 64, 64, None),  # head dim 80 (zamba2's shared block)
    (2, 256, 8, 8, 80, 128, 128, None),
]
BF16_CASES = [  # the bf16 kernel only: bf16 takes what float32 does not
    (1, 256, 8, 2, 192, 128, 128, None),  # head dim 192 (nemotron-4-340b)
    (1, 384, 4, 2, 192, 128, 128, 100),  # head dim 192 with a window, 64-key tiles
]
SERVE_LIKE_CASES = [  # both kernels
    (2, 512, 8, 2, 128, 128, 128, None),  # granite's head dim, S = 512
    (2, 512, 8, 8, 80, 128, 128, None),  # zamba2's head dim, S = 512
    (1, 512, 4, 2, 128, 128, 128, 200),  # a window at S = 512
    (1, 512, 4, 2, 128, 256, 64, None),  # blk_q above 128
]
SSD_CASES = [  # (B, S, H, P, G, N, chunk), tests/test_kernels.py:110-118, then zamba2's widths
    (1, 64, 2, 16, 1, 8, 16),
    (2, 128, 4, 16, 2, 8, 32),
    (1, 128, 4, 32, 1, 16, 64),
    (1, 256, 8, 16, 4, 8, 32),
    (1, 256, 4, 64, 1, 64, 128),
]
SSD_EDGE_CASES = [  # (B, S, H, P, G, N, chunk); a work unit of the kernel takes five heads
    (2, 256, 12, 32, 2, 16, 64),  # G > 1, five heads of a group share C.B^T, then one
    (1, 128, 7, 16, 1, 16, 32),  # H not a multiple of the unit's heads
    (1, 128, 8, 32, 2, 16, 64),  # nor H / G: a partial unit of four heads per group
    (2, 128, 4, 64, 1, 64, 128),  # Q = 128 with S = Q: one chunk
    (1, 128, 4, 16, 1, 32, 64),  # P and N below 64
    (1, 128, 4, 32, 1, 16, 64),
    (1, 128, 3, 24, 1, 40, 64),  # P, N not multiples of 16
    (1, 96, 2, 18, 1, 10, 32),  # nor of 4: padded by the wrapper
    (1, 100, 3, 32, 1, 32, 100),  # S not a multiple of the kernel's 64-step chunks
    (1, 512, 5, 64, 1, 64, 256),  # a chunk above 128
    (1, 512, 10, 64, 1, 64, 128),  # zamba2's widths, two units of five heads
    (2, 256, 4, 64, 4, 64, 128),  # one head per group: units of one head
]
RWKV6_CASES = [  # (B, S, H, P, chunk), tests/test_kernels.py:74-77, then rwkv6-3b's widths
    (1, 64, 2, 16, 16),
    (2, 128, 3, 16, 32),
    (1, 96, 1, 32, 32),
    (1, 32, 2, 8, 32),
    (1, 128, 4, 64, 32),
    (1, 96, 2, 64, 32),  # S not a multiple of the kernel's 64-step chunks
    (2, 32, 3, 64, 16),  # S below one chunk
    (1, 128, 2, 64, 16),  # chunks 16, 64, 128: the result does not depend on the chunk
    (1, 256, 2, 64, 64),
    (1, 256, 2, 64, 128),
    (1, 64, 2, 18, 32),  # P = 18: padded for TMA's 16-byte strides
    (3, 128, 5, 64, 64),  # B * H = 15 blocks, odd
    (1, 512, 2, 64, 64),  # rwkv6's widths over eight chunks (with logw = -5 too)
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


def _check_flash(case, dtype):
    """One launch of the kernel that the dtype selects (bf16:
    flash_fwd_sm90.cu, float32: the split-TF32 flash_fwd_tf32_sm90.cu), held
    against the plain version."""
    q, k, v = _inputs(case, dtype)
    _, _, _, _, _, blk_q, blk_k, window = case
    before = (ops.launches, ops.tensor_core_launches, ops.tf32_launches)
    got = ops.flash_attention(q, k, v, window=window, blk_q=blk_q, blk_k=blk_k)
    bf16 = dtype == torch.bfloat16
    assert (ops.launches, ops.tensor_core_launches, ops.tf32_launches) == (
        before[0] + 1, before[1] + bf16, before[2] + (not bf16))
    assert got.device.type == "cuda" and got.dtype == dtype and got.shape == q.shape
    want = ref.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=window
    ).transpose(1, 2)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_kernel_matches_plain_version(cuda, case, dtype):
    _check_flash(case, dtype)


MODALITY_CASES = [  # (B, S, H, K, hd, blk_q, blk_k, window) of the modality configs' prompt forwards
    (8, 768, 14, 2, 64, 128, 128, None),  # internvl2-1b: GQA 7:1, 256 patches + 512 tokens
    (8, 512, 32, 32, 64, 128, 128, None),  # musicgen-large: MHA at hd 64
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MODALITY_CASES)
def test_flash_kernel_at_the_modality_shapes(cuda, case, dtype):
    _check_flash(case, dtype)


@pytest.mark.parametrize("case", BF16_CASES)
def test_flash_tensor_core_kernel_matches_plain_version(cuda, case):
    _check_flash(case, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVE_LIKE_CASES)
def test_flash_kernel_serve_like_cases_match_plain_version(cuda, case, dtype):
    _check_flash(case, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 96])
def test_flash_kernel_without_causal_mask_matches_plain_version(cuda, window, dtype):
    """causal=False: every key live (or the window's band on one side), S
    not a multiple of either kernel's tiles."""
    q, k, v = _inputs((2, 200, 8, 2, 64), dtype)
    got = ops.flash_attention(q, k, v, causal=False, window=window, blk_q=200, blk_k=200)
    want = ref.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False, window=window
    ).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_kernel_routes_by_dtype(cuda):
    """float32 takes head dims up to 128 (hd 192 raises) and tiles on its
    own, so blk_q 256 runs on the split-TF32 kernel; bf16 takes both."""
    q, k, v = _inputs((1, 256, 4, 2, 192), torch.float32)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v)
    q, k, v = _inputs((1, 256, 4, 2, 64), torch.float32)
    before = (ops.tensor_core_launches, ops.tf32_launches)
    ops.flash_attention(q, k, v, blk_q=256)
    assert (ops.tensor_core_launches, ops.tf32_launches) == (before[0], before[1] + 1)
    ops.flash_attention(*(t.to(torch.bfloat16) for t in (q, k, v)), blk_q=256)
    assert (ops.tensor_core_launches, ops.tf32_launches) == (before[0] + 1, before[1] + 1)


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


def _check_ssd(case, dtype):
    """One launch of the tensor-core SSD kernel, held elementwise against
    the plain version on the card."""
    B, S, H, P, G, N, chunk = case
    gen = torch.Generator(device="cuda").manual_seed(5)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    xh, bm, cm = rn(B, S, H, P).to(dtype), rn(B, S, G, N).to(dtype), rn(B, S, G, N).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H))
    before = ssd_ops.launches
    y, st = ssd_ops.ssd_scan(xh, dt, A, bm, cm, chunk=chunk)
    assert ssd_ops.launches == before + 1
    torch.cuda.synchronize()
    assert y.shape == (B, S, H, P) and st.shape == (B, H, N, P)
    xw = (xh.float() * dt[..., None]).transpose(1, 2)
    la = (dt * A).transpose(1, 2)[..., None]
    y_ref, st_ref = ssd_ref.ssd_reference(xw, la, bm.transpose(1, 2), cm.transpose(1, 2))
    tol = TOL[dtype]
    torch.testing.assert_close(y, y_ref.transpose(1, 2), atol=tol, rtol=tol)
    torch.testing.assert_close(st, st_ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain_version(cuda, case, dtype):
    _check_ssd(case, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_EDGE_CASES)
def test_ssd_kernel_edges_match_plain_version(cuda, case, dtype):
    _check_ssd(case, dtype)


@pytest.mark.parametrize("logw", [None, -5.0])  # the sweep's draw; strong decay
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RWKV6_CASES)
def test_rwkv6_kernel_matches_plain_version(cuda, case, dtype, logw):
    B, S, H, P, chunk = case
    gen = torch.Generator(device="cuda").manual_seed(3)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    r, k, v = (rn(B, S, H, P).to(dtype) for _ in range(3))
    lw = -torch.exp(rn(B, S, H, P) - 1.0) if logw is None else torch.full((B, S, H, P), logw, device="cuda")
    u = rn(H, P) * 0.1
    before = rwkv6_ops.launches
    out, st = rwkv6_ops.rwkv6_mix(r, k, v, lw, u, chunk=chunk)
    assert rwkv6_ops.launches == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    hm = lambda t: t.transpose(1, 2)
    o_ref, st_ref = rwkv6_ref.rwkv6_reference(hm(r), hm(k), hm(v), hm(lw), u)
    tol = TOL[dtype]
    torch.testing.assert_close(out, hm(o_ref), atol=tol, rtol=tol)
    torch.testing.assert_close(st, st_ref, atol=tol, rtol=tol)


def test_scan_kernels_reject_what_they_do_not_take(cuda):
    z = lambda *shape: torch.zeros(*shape, device="cuda")
    with pytest.raises(NotImplementedError):  # state dim above 64
        ssd_ops.ssd_scan(z(1, 64, 2, 16), z(1, 64, 2), z(2), z(1, 64, 1, 128), z(1, 64, 1, 128))
    with pytest.raises(ValueError, match="packed"):
        xh = z(1, 2, 64, 16).transpose(1, 2)  # (B, S, H, P) with H not packed
        ssd_ops.ssd_scan(xh, z(1, 64, 2), z(2), z(1, 64, 1, 8), z(1, 64, 1, 8))
    with pytest.raises(ValueError, match="contiguous"):
        r = z(1, 2, 64, 16).transpose(1, 2)
        rwkv6_ops.rwkv6_mix(r, r.contiguous(), r.contiguous(), r.contiguous(), z(2, 16))
    with pytest.raises(NotImplementedError):  # head dim above 64
        r = z(1, 32, 1, 128)
        rwkv6_ops.rwkv6_mix(r, r, r, r, z(1, 128))


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen1.5-110b", "zamba2-2.7b", "rwkv6-3b"])
def test_kernel_prefill_matches_torch_path(cuda, name):
    """The model's forward through the kernels against its plain paths, in
    float32 on the card: flash once per attention block (on the split-TF32
    kernel), SSD once per Mamba2 layer, RWKV6 once per layer."""
    cfg = dataclasses.replace(
        get_arch(name).reduced(), param_dtype="float32", activation_dtype="float32"
    )
    params = build_model(cfg).init(0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(device="cuda").manual_seed(1))
    counters = (ops, ssd_ops, rwkv6_ops)
    before = [m.launches for m in counters]
    before_tf32 = ops.tf32_launches
    with torch.inference_mode():
        fast, _ = build_model(cfg, impl="kernel").forward(params, {"tokens": tokens})
        plain, _ = build_model(cfg).forward(params, {"tokens": tokens})
    assert ops.tf32_launches - before_tf32 == ops.launches - before[0]
    if cfg.family == "hybrid":
        want = [cfg.n_layers // cfg.shared_attn_every, cfg.n_layers, 0]
    elif cfg.rwkv is not None:
        want = [0, 0, cfg.n_layers]
    else:
        want = [cfg.n_layers, 0, 0]
    assert [m.launches - b for m, b in zip(counters, before)] == want
    torch.testing.assert_close(fast, plain, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", ["granite-3-8b", "zamba2-2.7b"])
def test_kernel_prefill_matches_torch_path_bf16(cuda, name):
    """The same in bf16, the serve path's dtype: every flash launch goes to
    the tensor-core kernel; 2e-2, the bf16 kernel tolerance."""
    cfg = get_arch(name).reduced()
    assert cfg.param_dtype == "bfloat16" and cfg.activation_dtype == "bfloat16"
    params = build_model(cfg).init(0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda,
                           generator=torch.Generator(device="cuda").manual_seed(1))
    before, before_tc = ops.launches, ops.tensor_core_launches
    with torch.inference_mode():
        fast, _ = build_model(cfg, impl="kernel").forward(params, {"tokens": tokens})
        plain, _ = build_model(cfg).forward(params, {"tokens": tokens})
    want = cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid" else cfg.n_layers
    assert ops.launches - before == want
    assert ops.tensor_core_launches - before_tc == want
    torch.testing.assert_close(fast.float(), plain.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "internvl2-1b", "musicgen-large"])
def test_forward_and_loss_on_the_card_match_cpu(cuda, name):
    """The reduced float32 model on the card against the CPU from the same
    parameters and batch: logits, loss and every metric (the MoE's aux
    loss and drop rate) at 2e-4; the kernel forward launches flash once per
    layer, except mixtral's, whose 16 positions exceed its reduced window
    of 8 and take the banded path."""
    from repro_torch import tree
    from repro_torch.models import synthetic_batch

    cfg = dataclasses.replace(get_arch(name).reduced(), param_dtype="float32", activation_dtype="float32")
    params = build_model(cfg).init(0, device="cpu")
    batch = synthetic_batch(cfg, 2, 16, seed=1, device="cpu")
    on_card = lambda t: tree.tree_map(lambda x: x.to(cuda), t)
    want_logits, _ = build_model(cfg).forward(params, batch)
    want_loss, want_m = build_model(cfg).loss(params, batch)
    got_logits, _ = build_model(cfg).forward(on_card(params), on_card(batch))
    got_loss, got_m = build_model(cfg).loss(on_card(params), on_card(batch))
    torch.testing.assert_close(got_logits.cpu(), want_logits, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(got_loss.cpu(), want_loss, atol=2e-4, rtol=2e-4)
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        torch.testing.assert_close(got_m[k].cpu(), want_m[k], atol=2e-4, rtol=2e-4)
    before = ops.launches
    with torch.inference_mode():
        fast, _ = build_model(cfg, impl="kernel").forward(on_card(params), on_card(batch))
    S = fast.shape[1]
    assert ops.launches - before == (0 if cfg.sliding_window and S > cfg.sliding_window else cfg.n_layers)
    torch.testing.assert_close(fast.cpu(), want_logits, atol=2e-4, rtol=2e-4)


def test_mixtral_greedy_tokens_on_the_card_match_cpu(cuda):
    """Reduced float32 mixtral served greedily (teacher-forced prefill past
    its window of 8, then 12 tokens) on the card and on the CPU: the same
    tokens, last prompt logits at 2e-4."""
    from repro_torch import tree
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(), param_dtype="float32",
                              activation_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 10), generator=torch.Generator().manual_seed(5))
    out = {}
    with torch.inference_mode():
        for device in ("cpu", cuda):
            p = tree.tree_map(lambda x: x.to(device), params)
            cache = model.init_cache(3, 22, device=device)
            last, cache = serve.prefill_by_decode(model, p, cache, prompts.to(device))
            out[str(device)] = (last.cpu(), serve.greedy_decode(model, p, cache, last, 10, 12).cpu())
    (l_cpu, t_cpu), (l_gpu, t_gpu) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(l_gpu, l_cpu, atol=2e-4, rtol=2e-4)
    assert torch.equal(t_gpu, t_cpu)


def test_rwkv6_time_mix_kernel_route_takes_chunk_128(cuda):
    """``apply_time_mix``'s default chunk (128) runs on the kernel route on
    the card, with bfloat16 activations, and agrees with the torch route."""
    from repro_torch.models import rwkv

    cfg = get_arch("rwkv6-3b").reduced()
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = rwkv.init_time_mix(gen, cfg, torch.bfloat16, "cuda")
    x = torch.randn(2, 256, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    prev = torch.zeros(2, cfg.d_model, dtype=torch.bfloat16, device="cuda")
    before = rwkv6_ops.launches
    out_k, st_k, _ = rwkv.apply_time_mix(p, x, cfg, prev, None, impl="kernel")
    assert rwkv6_ops.launches == before + 1
    out_t, st_t, _ = rwkv.apply_time_mix(p, x, cfg, prev, None, impl="torch")
    torch.testing.assert_close(st_k, st_t, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(out_k.float(), out_t.float(), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------
def _train(cfg, device, microbatches, steps=2):
    """``steps`` train steps from seed-0 parameters (made on the CPU and
    copied, so both devices start equal); returns (metrics, params)."""
    from repro_torch import tree
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    params = tree.tree_map(lambda p: p.to(device), build_model(cfg).init(0, device="cpu"))
    state = adamw.init(params)
    step = make_train_step(build_model(cfg), adamw.AdamWConfig(lr=1e-3, warmup_steps=1), microbatches)
    tokens = torch.randint(0, cfg.vocab_size, (steps, 4, 32), generator=torch.Generator().manual_seed(2))
    for i in range(steps):
        params, state, metrics = step(params, state, {"tokens": tokens[i].to(device)})
    return metrics, params


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["granite-3-8b", "zamba2-2.7b", "rwkv6-3b"])
def test_train_step_on_the_card_matches_cpu(cuda, name, microbatches):
    from repro_torch import tree

    cfg = dataclasses.replace(get_arch(name).reduced(), param_dtype="float32", activation_dtype="float32")
    m_cpu, p_cpu = _train(cfg, "cpu", microbatches)
    m_gpu, p_gpu = _train(cfg, cuda, microbatches)
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], atol=2e-4, rtol=2e-4)
    for a, b in zip(tree.leaves(p_gpu), tree.leaves(p_cpu)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=2e-4)


def test_checkpoint_round_trip_of_cuda_tensors(cuda, tmp_path):
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import adamw

    params = build_model(get_arch("zamba2-2.7b").reduced()).init(0, device=cuda)
    saved = (params, adamw.init(params))
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(3, saved).result()
    step, restored = mgr.restore(tree.tree_map(torch.zeros_like, saved))
    assert step == 3
    for a, b in zip(tree.leaves(restored), tree.leaves(saved)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["granite-3-8b", "zamba2-2.7b", "rwkv6-3b"])
def test_kernel_paths_refuse_autograd_on_the_card(cuda, name):
    """Under autograd a kernel model raises before any launch (on the card
    the kernels' outputs would carry no gradient); the train step refuses
    it when it is built."""
    from repro_torch import tree
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = get_arch(name).reduced()
    model = build_model(cfg, impl="kernel")
    with pytest.raises(ValueError, match="impl='torch'"):
        make_train_step(model, adamw.AdamWConfig())
    params = tree.tree_map(lambda p: p.requires_grad_(), model.init(0, device=cuda))
    counters = (ops, ssd_ops, rwkv6_ops)
    before = [m.launches for m in counters]
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(params, {"tokens": torch.zeros(2, 64, dtype=torch.long, device=cuda)})
    assert [m.launches for m in counters] == before


# ---------------------------------------------------------------------------
# The network engines' passes (repro_torch.network): the card against the
# port's CPU path on the same inputs.
# ---------------------------------------------------------------------------
def _net_messages(seed, dims, m):
    rng = np.random.default_rng(seed)
    src = np.stack([rng.integers(0, a, m) for a in dims], axis=1)
    dst = np.stack([rng.integers(0, a, m) for a in dims], axis=1)
    return src, dst, rng.integers(1, 5, m).astype(np.float64)


@pytest.mark.parametrize("dims", [(16, 4, 4, 4, 2), (7, 5, 3), (4, 1, 6)])
@pytest.mark.parametrize("split_ties", [True, False])
def test_network_route_loads_on_the_card_are_exact(cuda, dims, split_ties):
    """index_add_ and cumsum sum in any order on the card; integer volumes
    keep the loads exact."""
    for traffic in (_net_messages(0, dims, 4096), net.bisection_pairing(dims)):
        card = net.route_dor(dims, *traffic, split_ties=split_ties, device="cuda")
        assert np.array_equal(card, net.route_dor(dims, *traffic, split_ties=split_ties, device="cpu"))


def test_network_argmin_takes_the_first_tie_on_the_card(cuda):
    """The drain's next completion is the first flow of least remaining /
    rate, as np.argmin and jnp.argmin take it."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [torch.inf] * 4], dtype=torch.float64, device=cuda)
    assert x.argmin(dim=1).tolist() == [1, 0]
    ties = torch.ones(3, 1 << 18, dtype=torch.float64, device=cuda)
    ties[1, 7] = ties[1, 100_000] = 0.5
    assert ties.argmin(dim=1).tolist() == [0, 7, 0]


@pytest.mark.parametrize("machine, job, float_lane", [
    ((16, 16, 16), (4, 4, 4), True),  # a lane with no exact sums: still the same steps
    ((8, 6, 4), (8, 6, 4), False),  # ties in every dimension; a float lane would take 1536 steps
])
def test_network_drain_on_the_card_matches_cpu(cuda, machine, job, float_lane):
    src, dst, _ = net.bisection_pairing(job)
    paths = net.dor_paths(machine, src, dst, np.ones(src.shape[0]))
    rng = np.random.default_rng(1)
    vols = rng.integers(1, 3, size=(8, paths.n_flows)).astype(np.float64)
    if float_lane:
        vols[7] = rng.random(paths.n_flows) + 0.5
    plan = net.prepare_drain(paths, device="cuda")
    fc, steps = net.drain_batch(plan, vols)
    fc_cpu, steps_cpu = net.drain_batch(net.prepare_drain(paths, device="cpu"), vols)
    np.testing.assert_allclose(fc, fc_cpu, rtol=1e-9, atol=1e-12)
    assert np.array_equal(steps, steps_cpu)
    for i in (0, 7):
        one, one_steps = net.drain(plan, vols[i])
        assert np.array_equal(one, fc[i]) and one_steps == steps[i]


@pytest.mark.parametrize("dims, makespan", [((16, 4, 4, 4, 2), 4.0), ((8, 8, 4, 4, 2), 2.0)])
def test_network_table1_partition_drains_on_the_card(cuda, dims, makespan):
    """The paper's 4-midplane pair: Mira's current partition against the
    proposed one (makespans from the JAX package's NumPy engine)."""
    res = net.simulate_traffic(dims, net.bisection_pairing(dims), device="cuda")
    ref = net.simulate_traffic(dims, net.bisection_pairing(dims), device="cpu")
    assert res.makespan == makespan and res.steps == ref.steps == 1
    np.testing.assert_allclose(res.flow_completion, ref.flow_completion, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dims, logical, batch", [((4, 4, 3, 2), (4, 3, 2), 512), ((16, 4, 4, 4, 2), (16, 4, 4, 4, 2), 16)])
def test_network_score_candidates_on_the_card_are_row_exact(cuda, dims, logical, batch):
    rng = np.random.default_rng(2)
    traffic = net.pattern_traffic(logical, "pairing")
    n_cells, n_ranks = net.volume(dims), net.volume(logical)
    cells = np.stack([rng.choice(n_cells, n_ranks, replace=False) for _ in range(batch)])
    coords = np.stack(np.unravel_index(cells, dims), axis=-1)
    cong, dil = net.score_candidates(dims, coords, traffic, device="cuda")
    cong_cpu, dil_cpu = net.score_candidates(dims, coords, traffic, device="cpu")
    assert np.array_equal(cong, cong_cpu) and np.array_equal(dil, dil_cpu)


def test_network_contention_field_on_the_card_matches_cpu(cuda):
    dims = (16, 8, 8, 4, 2)
    grid = np.zeros(dims, dtype=bool)
    grid[:8, :4, :4] = True
    grid[8:12, 4:8] = True
    mask = net.interference_mask(grid)
    for oriented in net.orientations((12, 4, 2, 2, 2), dims):
        card = net.contention_field(dims, oriented, mask, device="cuda")
        cpu = net.contention_field(dims, oriented, mask, device="cpu")
        assert np.abs(card - cpu).max() <= 1e-9 * max(1.0, float(np.abs(cpu).max()))
        assert np.argmin(np.round(card, 9)) == np.argmin(np.round(cpu, 9))


@pytest.mark.parametrize("dims", [(4, 4, 3, 2), (7, 2, 2, 2), (4, 4, 4, 3), (16, 16, 12, 8, 2)])
def test_network_cut_table_on_the_card_is_int64_identical(cuda, dims):
    unit = 512 if len(dims) == 5 else 1
    for mp in (1, 2, 4, 8, 16, 24, 32, 48, 64, 96):
        card = net.cut_table(dims, mp * unit, device="cuda")
        cpu = net.cut_table(dims, mp * unit, device="cpu")
        assert card.items() == cpu.items() and card.cuts.dtype == np.int64


# ---------------------------------------------------------------------------
# The allocation engines (placement search, scheduler, rank mapping): the
# card against the port's CPU path on the same inputs.
# ---------------------------------------------------------------------------
def _record(e):
    placement = None if e.placement is None else dataclasses.astuple(e.placement)
    request = None if e.request is None else dataclasses.astuple(e.request)
    return (e.time, e.kind, e.seq, e.job_id, e.cells, request, placement, e.priority, e.reason, e.source)


@pytest.mark.parametrize("dims, geometry", [((16, 8, 8), (6, 4, 4)), ((12, 8, 8), (8, 8, 8)), ((7, 2, 2, 2), (4, 2, 1, 1))])
def test_allocation_scored_placement_on_the_card_matches_cpu(cuda, dims, geometry):
    rng = np.random.default_rng(3)
    machines = {dev: net.MachineState(dims, device=dev) for dev in ("cuda", "cpu")}
    for jid in range(12):
        g = tuple(int(rng.integers(1, min(4, a) + 1)) for a in dims)
        placed = {dev: m.allocate_scored(jid, g) for dev, m in machines.items()}
        assert placed["cuda"] == placed["cpu"]
    assert np.array_equal(machines["cuda"].traffic_loads(), machines["cpu"].traffic_loads())
    grid = machines["cpu"].grid.numpy()
    bg = machines["cpu"].traffic_loads()
    card = net.best_placement(grid, geometry, bg, device="cuda")
    assert card == net.best_placement(grid, geometry, bg, device="cpu")
    assert net.first_fit(grid, geometry, device="cuda") == net.first_fit(grid, geometry, device="cpu")


def test_allocation_scheduler_scenario_on_the_card_matches_cpu(cuda):
    scenario = net.generate_scenario((16, 16, 16), 80, seed=1, burst_gap=30.0, mean_duration=80.0,
                                     failure_rate=0.002, repair_delay=150.0)
    for policy in (net.ContentionScoredPolicy, net.IsoperimetricPolicy):
        card = net.run_scenario(scenario, policy(), backfill=True, device="cuda")
        cpu = net.run_scenario(scenario, policy(), backfill=True, device="cpu")
        assert [_record(e) for e in card.log] == [_record(e) for e in cpu.log]
        assert card.machine.grid.device.type == "cuda"


def test_allocation_queue_with_simulated_contention_on_the_card(cuda):
    rng = np.random.default_rng(4)
    jobs = [net.JobRequest(i, int(rng.choice([2, 4, 6, 8, 12])), duration=float(rng.uniform(1, 9)),
                           arrival=float(i)) for i in range(16)]
    for pattern in (None, "halo"):
        res = {dev: net.simulate_queue((6, 4, 2), jobs, net.ElongatedPolicy(), contention="simulated",
                                       mapping_pattern=pattern, device=dev) for dev in ("cuda", "cpu")}
        for a, b in zip(res["cuda"].jobs, res["cpu"].jobs):
            assert a.placement == b.placement and (a.start, a.end) == (b.start, b.end)
            assert a.comm_lower_bound == b.comm_lower_bound
            np.testing.assert_allclose(a.simulated_comm_time, b.simulated_comm_time, rtol=1e-9, atol=1e-12)


def test_allocation_map_ranks_chunks_on_the_card(cuda, monkeypatch):
    dims, job = (16, 16, 12, 8, 2), (4, 4, 4, 4, 2)
    orders = list(net.axis_permutation_orders(job))[:96]
    from repro_torch.network import backend, mapping

    coords = np.stack([mapping.axis_order_coords(dims, job, (1, 2, 3, 4, 0), p, r) for p, r in orders])
    traffic = net.pattern_traffic(job, "halo")
    whole = backend.score_candidates(dims, coords, traffic, device="cuda")
    cpu = backend.score_candidates(dims, coords, traffic, device="cpu")
    monkeypatch.setattr(backend, "SCORE_BUDGET_BYTES", 1 << 20)
    assert backend.score_chunk(dims, traffic[0].shape[0]) < len(coords)
    chunked = backend.score_candidates(dims, coords, traffic, device="cuda")
    for a, b, c in zip(whole, chunked, cpu):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    card = net.map_ranks(dims, job, (1, 2, 3, 4, 0), pattern="pairing", device="cuda")
    ref = net.map_ranks(dims, job, (1, 2, 3, 4, 0), pattern="pairing", device="cpu")
    assert (card.strategy, card.score) == (ref.strategy, ref.score)
    assert np.array_equal(card.coords, ref.coords) and np.array_equal(card.loads, ref.loads)


def test_allocation_advisor_on_the_card_matches_cpu(cuda):
    table = {4: (4, 1, 1, 1), 8: (4, 2, 1, 1), 24: (4, 3, 2, 1)}
    card = net.advise_policy_table((4, 4, 3, 2), table, unit_node_dims=(4, 4, 4, 4, 2), simulate=True, device="cuda")
    cpu = net.advise_policy_table((4, 4, 3, 2), table, unit_node_dims=(4, 4, 4, 4, 2), simulate=True, device="cpu")
    assert card == cpu
    assert [a.predicted_speedup for a in card] == [a.simulated_speedup for a in card] == [2.0, 2.0, 4.0 / 3.0]


# ---------------------------------------------------------------------------
# The fleet planner: the mapping catalogue, the geometry tables and the drain
# on the card give the CPU path's rows bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "nemotron-4-340b"])
def test_planner_rows_on_the_card_equal_cpu(cuda, arch):
    from repro_torch.core import bgq
    from repro_torch.launch import planner

    kw = dict(pod=planner.bgq_pod("mira"), shape="train_4k", wrap_mode="torus",
              unit_node_dims=bgq.MIDPLANE_DIMS, simulate_top_k=3)
    card = planner.plan_model(arch, 16, device="cuda", **kw)
    cpu = planner.plan_model(arch, 16, device="cpu", **kw)
    assert [c.row() for c in card.table] == [c.row() for c in cpu.table]
    np.testing.assert_allclose([c.simulated_slowdown for c in card.table],
                               [c.simulated_slowdown for c in cpu.table], rtol=1e-9, atol=0)


# ---------------------------------------------------------------------------
# The rest of the network engines: the adaptive router, the timeline,
# contention attribution and HyperX, on the card against the CPU path.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims", [(16, 4, 4, 4, 2), (8, 8, 4, 4, 2), (7, 5, 3)])
def test_engines_adaptive_paths_on_the_card_equal_cpu(cuda, dims):
    """cumsum prefixes of an integer field are exact on the card, so every
    decision and link id equals the CPU path's."""
    for traffic in (net.bisection_pairing(dims), _net_messages(3, dims, 2048), net.hotspot_line(dims)):
        a = net.adaptive_paths(dims, *traffic, device="cuda")
        b = net.adaptive_paths(dims, *traffic, device="cpu")
        assert np.array_equal(a.link_ids, b.link_ids) and np.array_equal(a.flow_ids, b.flow_ids)
    cmp = net.compare_routing(dims, net.hotspot_line(dims), device="cuda")
    assert dataclasses.astuple(cmp) == dataclasses.astuple(net.compare_routing(dims, net.hotspot_line(dims), device="cpu"))


def test_engines_timeline_on_the_card_matches_cpu(cuda):
    dims = (8, 6, 4)
    paths = net.adaptive_paths(dims, *_net_messages(4, dims, 600), device="cuda")
    res = net.simulate_flows(paths, record_utilization=True, device="cuda")
    ref = net.simulate_flows(paths, record_utilization=True, device="cpu")
    assert res.steps == ref.steps == len(res.timeline) > 1
    for a, b in zip(res.timeline, ref.timeline):
        assert a.active_flows == b.active_flows
        np.testing.assert_allclose([a.start, a.end, a.max_utilization, a.mean_utilization],
                                   [b.start, b.end, b.max_utilization, b.mean_utilization], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a.utilization, b.utilization, rtol=1e-9, atol=1e-12)


def test_engines_attribution_on_the_card_equals_cpu(cuda):
    from repro_torch import obs

    reports = []
    for dev in ("cuda", "cpu"):
        m = net.MachineState((16, 16, 8), device=dev)
        for jid, oriented, offset in [(0, (12, 4, 2), (0, 0, 0)), (1, (4, 4, 2), (12, 0, 0)), (2, (4, 10, 4), (0, 4, 2))]:
            m.commit(jid, tuple(sorted(oriented, reverse=True)), oriented, offset)
        reports.append(obs.attribute_contention(m, top_hotspots=10))
    card, cpu = reports
    assert [dataclasses.astuple(j) for j in card.jobs] == [dataclasses.astuple(j) for j in cpu.jobs]
    assert [(h.dim, h.direction, h.cell, h.load, h.shares) for h in card.hotspots] == \
        [(h.dim, h.direction, h.cell, h.load, h.shares) for h in cpu.hotspots]
    assert card.cross_load == cpu.cross_load > 0.0
    assert obs.render_dashboard(card) == obs.render_dashboard(cpu)


@pytest.mark.parametrize("dims, mult", [((16, 16, 4), None), ((8, 6), (1, 3))])
def test_engines_hyperx_routing_on_the_card_matches_cpu(cuda, dims, mult):
    hx = net.HyperXFabric(dims, mult, link_bw=1.0)
    for traffic in (net.all_to_all(dims), _net_messages(5, dims, 20000), net.hotspot_line(dims)):
        minimal = net.route_hyperx(hx, *traffic, device="cuda")
        assert np.array_equal(minimal, net.route_hyperx(hx, *traffic, device="cpu"))
        np.testing.assert_allclose(net.route_hyperx(hx, *traffic, mode="dal", device="cuda"),
                                   net.route_hyperx(hx, *traffic, mode="dal", device="cpu"), rtol=1e-12, atol=0)
    pod = net.HyperXFabric((16, 4), link_bw=1.0)
    assert net.cut_table(pod, 16, device="cuda").items() == net.cut_table(pod, 16, device="cpu").items()
    a = net.compare_fabric_routing(pod, net.hotspot_line((16, 4)), device="cuda")
    b = net.compare_fabric_routing(pod, net.hotspot_line((16, 4)), device="cpu")
    np.testing.assert_allclose(dataclasses.astuple(a)[1:], dataclasses.astuple(b)[1:], rtol=1e-9)


def test_engines_moe_dispatch_on_the_card_equals_cpu(cuda):
    """The dispatch's exclusive cumulative count is integer-exact on the
    card: the MoE layer's slots, and so its output, match the CPU's."""
    from repro_torch.models import moe

    cfg = get_arch("mixtral-8x7b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn(2, 64, cfg.d_model, generator=gen)
    y_cpu, aux_cpu = moe.apply_moe(p, x, cfg)
    y, aux = moe.apply_moe({k: v.cuda() for k, v in p.items()}, x.cuda(), cfg)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=2e-4, atol=2e-4)
    assert float(aux["moe_drop_rate"]) == float(aux_cpu["moe_drop_rate"])


# ---------------------------------------------------------------------------
# The distributed layer: Strassen-Winograd and the collective-matmul rings
# ---------------------------------------------------------------------------
def test_strassen_depth2_on_the_card_matches_float64(cuda):
    """Depth-2 Strassen-Winograd at n = 2048, float32 without TF32, within
    1e-4 of the float64 product relative to its largest entry
    (benchmarks/matmul_scaling.py:34-35)."""
    from repro_torch.core.strassen import strassen_winograd

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(2048, 2048, generator=gen, device="cuda")
    b = torch.randn(2048, 2048, generator=gen, device="cuda")
    want = a.double() @ b.double()
    got = strassen_winograd(a, b, 2)
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-4


def test_collective_matmul_rings_on_a_one_rank_nccl_group(cuda):
    """Both rings on a one-rank NCCL group against x @ w within 1e-5
    relative; no exchange, gather or scatter is traced; the group is
    destroyed after."""
    import socket

    import torch.distributed as dist

    from repro_torch.analysis.roofline import CollectiveTrace
    from repro_torch.distributed.collective_matmul import allgather_matmul, matmul_reducescatter

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(512, 256, generator=gen, device="cuda")
        w = torch.randn(256, 384, generator=gen, device="cuda")
        want = x @ w
        with CollectiveTrace() as trace:
            for got in (allgather_matmul(x, w), matmul_reducescatter(x, w)):
                assert float((got - want).abs().max() / want.abs().max()) < 1e-5
        assert trace.ops == []
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


DRYRUN_CARD_PROG = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))
for name in sys.argv[1].split(","):
    rec = dryrun.dryrun_cell(get_arch(name).reduced(), ShapeConfig("train", 16, 4, "train"), mesh,
                             mesh_kind="reduced", link_bw=50e9, device="cuda", microbatches=2,
                             skip_calibration=True)
    print(json.dumps({"arch": name, "ok": rec["ok"], "replications": rec["view_replications"]}), flush=True)
"""


def test_dryrun_reduced_train_cells_on_the_card(cuda, tmp_path):
    """Reduced train cells through the dry-run on a fake (2, 4) group on the
    card: the card's torch refused what the CPU's ran (DTensor has no rule
    for the ``detach_`` that its autograd.Function applies to a parameter
    view gathered in the backward pass; the gather now takes it detached),
    the scans and the MoE dispatch on their shards."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    archs = ["granite-3-8b", "zamba2-2.7b", "rwkv6-3b", "mixtral-8x7b"]
    script = tmp_path / "dryrun_card.py"
    script.write_text(DRYRUN_CARD_PROG)
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, str(script), ",".join(archs)], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [r["arch"] for r in rows] == archs and all(r["ok"] for r in rows)


def test_dryrun_llama3_70b_train_single_fits_the_card(cuda):
    """llama3-70b x train_4k x single's production run, which JAX's
    microbatch table leaves at one microbatch of 16 rows a rank: block remat
    keeps each of the 80 layers' inputs as its 1/16 sequence slice over
    "model" (86 GB a rank whole, which ran out of the card's memory), so
    the CLI's checks pass and the peak is below the card's memory."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.launch import dryrun

    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3-70b",
                          "--shape", "train_4k", "--mesh", "single", "--link-bw", "50e9", "--force",
                          "--skip-calibration"], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads((dryrun.RESULTS_DIR / "llama3-70b__train_4k__single.json").read_text())
    assert rec["ok"] and rec["checks"] == []
    assert rec["memory_analysis"]["peak_allocated_bytes"] < torch.cuda.get_device_properties(0).total_memory
