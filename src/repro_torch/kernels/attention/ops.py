"""Public wrapper for the flash attention kernel (counterpart of
``repro.kernels.attention.ops.flash_attention``).

Takes the model's ``(B, S, H, hd)`` layout.  A CUDA tensor goes to a
hand-written tensor-core kernel (TMA and ``wgmma``), built at first use and
chosen by dtype: bfloat16 (the serve path) to ``csrc/flash_fwd_sm90.cu``,
float32 to ``csrc/flash_fwd_tf32_sm90.cu``, whose products are split TF32
(hi.hi + hi.lo + lo.hi, three TF32 products per product), which holds the
float32 tolerance that one TF32 product cannot
(``ref.attention_split_tf32_reference`` is its arithmetic on the CPU).  A
CPU tensor (float64 too) goes to the plain PyTorch version in ``ref.py``.
There is no fallback from one to another: on the card the chosen kernel
runs or the call raises.  ``launches`` counts launches of either kernel,
``tensor_core_launches`` those of the bf16 kernel and ``tf32_launches``
those of the float32 one (plain-version calls are not counted).

Training takes :func:`flash_attention_trainable` (causal, bf16, a head dim
in ``BWD_HEAD_DIMS``): while autograd records, :class:`FlashAttention`
runs the bf16 kernel's variant that also writes each row's log-sum-exp
(``stats_launches``) and, in the backward pass, ``csrc/flash_bwd_sm90.cu``
(``backward_launches``); on the CPU both are the plain versions in
``ref.py``.  Without autograd it is :func:`flash_attention`.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels import refuse_autograd

from .ref import attention_backward_reference, attention_reference, attention_stats_reference

# Kernel launches since the counters were last reset (chip_smoke.py sets
# each to 0 before it drives the main path).
launches = 0
tensor_core_launches = 0
tf32_launches = 0
stats_launches = 0  # of the bf16 kernel's variant that writes the log-sum-exp
backward_launches = 0  # of the backward kernels (one per backward pass)

# The head dims each kernel takes.  Both tile on their own (bf16: 128 q
# rows, 128 or 64 keys; float32: 128 q rows, 32 keys) whatever blk_q and
# blk_k are, since the result does not depend on the block sizes.
HEAD_DIMS = {
    torch.bfloat16: (16, 32, 64, 80, 128, 192),
    torch.float32: (16, 32, 64, 80, 128, 192),
}
KERNELS = {torch.bfloat16: "flash_fwd_sm90", torch.float32: "flash_fwd_tf32_sm90"}
# The head dims the backward kernels (and the forward's stats variant) take, in bf16.
BWD_HEAD_DIMS = (64, 80, 128)
STATS_ROWS = 128  # the log-sum-exp's rows are padded to a multiple of this

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o; B, S, H, K, hd, causal, window; scale; stream
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_F, _P]
_STATS_ARGTYPES = [_P] * 5 + [_I] * 5 + [_F, _P]  # q, k, v, o, lse; B, S, H, K, hd; scale; stream
# q, k, v, o, dout, lse, delta, dq, dk, dv; B, S, H, K, hd; scale; stream
_BWD_ARGTYPES = [_P] * 10 + [_I] * 5 + [_F, _P]


@lru_cache(maxsize=None)
def _kernel(stem: str):
    from repro_torch.kernels import _build

    lib = _build.library(stem)
    fn = getattr(lib, stem)
    fn.argtypes = _BWD_ARGTYPES if stem == "flash_bwd_sm90" else _ARGTYPES
    fn.restype = ctypes.c_int
    if stem == "flash_fwd_sm90":
        lib.flash_fwd_sm90_stats.argtypes = _STATS_ARGTYPES
        lib.flash_fwd_sm90_stats.restype = ctypes.c_int
    err = getattr(lib, f"{stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError("GQA requires n_heads % n_kv_heads == 0")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def _check(q, k, v, blk_q, blk_k, window):
    _check_shapes(q, k, v)
    if q.dtype not in HEAD_DIMS and not (q.device.type == "cpu" and q.dtype == torch.float64):
        raise TypeError(f"q, k, v must share a dtype in {list(HEAD_DIMS)} (or float64 on the cpu); "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    S = q.shape[1]
    if S % blk_q or S % blk_k:
        raise ValueError(f"sequence length {S} must be a multiple of blk_q={blk_q} and blk_k={blk_k}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, K, hd)
    v: torch.Tensor,  # (B, S, K, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    blk_q: int = 128,
    blk_k: int = 128,
) -> torch.Tensor:
    """Causal / sliding-window GQA attention; returns ``(B, S, H, hd)`` in
    q's dtype.  ``blk = min(blk, S)`` and ``S % blk == 0``, as in the JAX
    wrapper."""
    global launches, tensor_core_launches, tf32_launches
    S = q.shape[1]
    blk_q, blk_k = min(blk_q, S), min(blk_k, S)
    _check(q, k, v, blk_q, blk_k, window)
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        out = attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window,
        )
        return out.transpose(1, 2).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS[q.dtype]:
        raise NotImplementedError(f"head dim {hd} not in {HEAD_DIMS[q.dtype]} for {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    stem = KERNELS[q.dtype]
    _run(stem, stem, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         B, S, H, k.shape[2], hd, int(causal), -1 if window is None else int(window),
         1.0 / math.sqrt(hd))
    launches += 1
    tensor_core_launches += int(q.dtype == torch.bfloat16)
    tf32_launches += int(q.dtype == torch.float32)
    return out


def _run(stem: str, fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of the library built from ``csrc/<stem>.cu`` on the
    current stream of ``device``; raise if a launch failed."""
    lib = _kernel(stem)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        message = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{fn} launch failed: {message} (error {err})")


def _check_card(*named: tuple) -> None:
    """What the training kernels take on the card: bf16, a head dim in
    ``BWD_HEAD_DIMS``, contiguous and 16-byte aligned tensors."""
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bf16 on the card for training, not {t.dtype}")
        if t.shape[-1] not in BWD_HEAD_DIMS:
            raise NotImplementedError(f"head dim {t.shape[-1]} not in {BWD_HEAD_DIMS}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _forward_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention and each row's log-sum-exp: on the card the bf16
    kernel's variant that writes it, float32 (B, H, S rounded up to
    ``STATS_ROWS``); on the CPU the plain version, whose log-sum-exp is
    (B, H, S)."""
    global launches, tensor_core_launches, stats_launches
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        out, lse = attention_stats_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return out.transpose(1, 2).contiguous(), lse
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    _check_card(("q", q), ("k", k), ("v", v))
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, -(-S // STATS_ROWS) * STATS_ROWS), dtype=torch.float32, device=q.device)
    _run("flash_fwd_sm90", "flash_fwd_sm90_stats", q.device, q.data_ptr(), k.data_ptr(),
         v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, S, H, k.shape[2], hd, 1.0 / math.sqrt(hd))
    launches += 1
    tensor_core_launches += 1
    stats_launches += 1
    return out, lse


def _backward(q, k, v, out, lse, dout):
    """(dq, dk, dv) of causal attention from the forward's output and
    log-sum-exp: the backward kernels on the card, the plain version on the
    CPU."""
    global backward_launches
    if q.device.type == "cpu":
        grads = attention_backward_reference(*(t.transpose(1, 2) for t in (q, k, v, out)), lse,
                                             dout.transpose(1, 2))
        return tuple(g.transpose(1, 2).contiguous() for g in grads)
    _check_card(("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout))
    B, S, H, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    _run("flash_bwd_sm90", "flash_bwd_sm90", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
         dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], hd, 1.0 / math.sqrt(hd))
    backward_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention with a backward pass: the forward saves q, k,
    v, its output and each row's log-sum-exp, and the backward computes
    (dq, dk, dv) from them.  Block remat runs the forward again inside the
    backward pass, statistics included."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward_with_stats(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _backward(*ctx.saved_tensors, dout.contiguous())


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention over (B, S, H, hd) q and (B, S, K, hd) k and v,
    any S, in q's dtype, that autograd can differentiate: while autograd
    records, :class:`FlashAttention`; otherwise :func:`flash_attention`
    with blocks of S (they only enter its check of S: both kernels tile on
    their own).  On the card it takes bf16 and a head dim in
    ``BWD_HEAD_DIMS`` (``layers.run_attention`` routes only such calls
    here); on the CPU any floating type, through the plain versions."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v)
    S = q.shape[1]
    return flash_attention(q, k, v, causal=True, blk_q=S, blk_k=S)
