"""Public wrapper for the flash attention kernel (counterpart of
``repro.kernels.attention.ops.flash_attention``).

Takes the model's ``(B, S, H, hd)`` layout.  A CUDA tensor goes to a
hand-written tensor-core kernel (TMA and ``wgmma``), built at first use and
chosen by dtype: bfloat16 (the serve path) to ``csrc/flash_fwd_sm90.cu``,
float32 to ``csrc/flash_fwd_tf32_sm90.cu``, whose products are split TF32
(hi.hi + hi.lo + lo.hi, three TF32 products per product), which holds the
float32 tolerance that one TF32 product cannot
(``ref.attention_split_tf32_reference`` is its arithmetic on the CPU).  A
CPU tensor goes to the plain PyTorch version in ``ref.py``.  There is no
fallback from one to another: on the card the chosen kernel runs or the
call raises.  ``launches`` counts launches of either kernel,
``tensor_core_launches`` those of the bf16 kernel and ``tf32_launches``
those of the float32 one (plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels import refuse_autograd

from .ref import attention_reference

# Kernel launches since the counters were last reset (chip_smoke.py sets
# each to 0 before it drives the main path).
launches = 0
tensor_core_launches = 0
tf32_launches = 0

# The head dims each kernel takes.  Both tile on their own (bf16: 128 q
# rows, 128 or 64 keys; float32: 128 q rows, 32 keys) whatever blk_q and
# blk_k are, since the result does not depend on the block sizes.
HEAD_DIMS = {
    torch.bfloat16: (16, 32, 64, 80, 128, 192),
    torch.float32: (16, 32, 64, 80, 128, 192),
}
KERNELS = {torch.bfloat16: "flash_fwd_sm90", torch.float32: "flash_fwd_tf32_sm90"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o; B, S, H, K, hd, causal, window; scale; stream
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_F, _P]


@lru_cache(maxsize=None)
def _kernel(stem: str):
    from repro_torch.kernels import _build

    lib = _build.library(stem)
    fn = getattr(lib, stem)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, blk_q, blk_k, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError("GQA requires n_heads % n_kv_heads == 0")
    if q.dtype not in HEAD_DIMS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(HEAD_DIMS)}; got {q.dtype}, {k.dtype}, {v.dtype}")
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
    lib = _kernel(stem)
    with torch.cuda.device(q.device):
        err = getattr(lib, stem)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], hd, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        message = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{stem} launch failed: {message} (error {err})")
    launches += 1
    tensor_core_launches += int(q.dtype == torch.bfloat16)
    tf32_launches += int(q.dtype == torch.float32)
    return out
