"""Public wrapper for the flash attention kernel (counterpart of
``repro.kernels.attention.ops.flash_attention``).

Takes the model's ``(B, S, H, hd)`` layout.  A CUDA tensor goes to the
hand-written kernel ``csrc/flash_fwd.cu`` (built at first use); a CPU tensor
goes to the plain PyTorch version in ``ref.py``.  There is no fallback from
one to the other: on the card the kernel runs or the call raises.
``launches`` counts kernel launches (plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional

import torch

from .ref import attention_reference

# Kernel launches since the counter was last reset (chip_smoke.py sets it to
# 0 before it drives the main path).
launches = 0

SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_BLK_Q = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    lib = _build.library("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, blk_q, blk_k, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError("GQA requires n_heads % n_kv_heads == 0")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPE_CODES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if S % blk_q or S % blk_k:
        raise ValueError(f"sequence length {S} must be a multiple of blk_q={blk_q} and blk_k={blk_k}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


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
    global launches
    S = q.shape[1]
    blk_q, blk_k = min(blk_q, S), min(blk_k, S)
    _check(q, k, v, blk_q, blk_k, window)
    if q.device.type == "cpu":
        out = attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window,
        )
        return out.transpose(1, 2).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, S, H, hd = q.shape
    if hd not in SUPPORTED_HEAD_DIMS:
        raise NotImplementedError(f"head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if blk_q > MAX_BLK_Q:
        raise NotImplementedError(f"blk_q {blk_q} > {MAX_BLK_Q}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], hd, blk_q, blk_k, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(hd),
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()} (cudaError {err})"
        )
    launches += 1
    return out
