"""Public wrapper for the SSD chunked-scan kernel (counterpart of
``repro.kernels.ssd.ops.ssd_scan``).

Takes the model's ``(B, S, ...)`` layout and returns ``y`` in it, with the
final state head-major, as the JAX wrapper does.  A CUDA tensor goes to the
hand-written kernel ``csrc/ssd_fwd.cu`` (built at first use), which reads
the model layout through (batch, sequence) strides, so no transposes run
around the launch; a CPU tensor goes to the plain PyTorch version in
``ref.py``.  There is no fallback from one to the other: on the card the
kernel runs or the call raises.  ``launches`` counts kernel launches
(plain-version calls are not counted).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from .ref import ssd_reference

# Kernel launches since the counter was last reset (chip_smoke.py sets it to
# 0 before it drives the main path).
launches = 0

MAX_CHUNK = 128
MAX_STATE_DIM = 64
MAX_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    lib = _build.library("ssd_fwd")
    fn = lib.ssd_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.ssd_fwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(xh, dt, A, bm, cm, Q):
    if xh.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or bm.dim() != 4 or cm.dim() != 4:
        raise ValueError("expected xh (B,S,H,P), dt (B,S,H), A (H,), bm/cm (B,S,G,N)")
    B, S, H, P = xh.shape
    G, N = bm.shape[2], bm.shape[3]
    if dt.shape != (B, S, H) or A.shape != (H,) or bm.shape != (B, S, G, N) or cm.shape != bm.shape:
        raise ValueError(
            f"shapes do not match: xh {tuple(xh.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"bm {tuple(bm.shape)}, cm {tuple(cm.shape)}"
        )
    if H % G:
        raise ValueError(f"heads {H} must be a multiple of groups {G}")
    if S % Q:
        raise ValueError(f"sequence length {S} must be a multiple of the chunk {Q}")
    for name, t in (("xh", xh), ("dt", dt), ("bm", bm), ("cm", cm)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if len({t.device for t in (xh, dt, A, bm, cm)}) != 1:
        raise ValueError("xh, dt, A, bm, cm must lie on one device")


def ssd_scan(
    xh: torch.Tensor,  # (B, S, H, P) raw head inputs
    dt: torch.Tensor,  # (B, S, H) positive step sizes
    A: torch.Tensor,  # (H,) negative decay rates
    bm: torch.Tensor,  # (B, S, G, N)
    cm: torch.Tensor,  # (B, S, G, N)
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan from a zero state.  Returns (y (B, S, H, P) f32, final state
    (B, H, N, P) f32).  ``Q = min(chunk, S)`` and ``S % Q == 0``, as in the
    JAX wrapper."""
    global launches
    S = xh.shape[1]
    Q = min(chunk, S)
    _check(xh, dt, A, bm, cm, Q)
    if xh.device.type == "cpu":
        dtf = dt.float()
        xw = (xh.float() * dtf[..., None]).transpose(1, 2)
        la = (dtf * A.float()).transpose(1, 2)[..., None]
        y, state = ssd_reference(xw, la, bm.transpose(1, 2), cm.transpose(1, 2))
        return y.transpose(1, 2), state
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {xh.device}")
    B, S, H, P = xh.shape
    G, N = bm.shape[2], bm.shape[3]
    if Q > MAX_CHUNK or N > MAX_STATE_DIM or P > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"chunk {Q} / state dim {N} / head dim {P} above the kernel's "
            f"{MAX_CHUNK} / {MAX_STATE_DIM} / {MAX_HEAD_DIM}"
        )
    if bm.dtype != xh.dtype or cm.dtype != xh.dtype:
        raise TypeError(f"xh, bm, cm must share a dtype; got {xh.dtype}, {bm.dtype}, {cm.dtype}")
    # The kernel walks (batch, sequence) by strides; inside a row it needs
    # the (H, P) and (G, N) elements packed (a stride of a size-1 dim is
    # never used).
    for name, t in (("xh", xh), ("bm", bm), ("cm", cm)):
        inner = t.shape[3]
        if (inner > 1 and t.stride(3) != 1) or (t.shape[2] > 1 and t.stride(2) != inner):
            raise ValueError(f"{name} must be packed in its last two dims")
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=xh.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=xh.device)
    lib = _kernel()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.ssd_fwd(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            B, S, H, P, G, N, Q,
            xh.stride(0), xh.stride(1), bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
            _DTYPE_CODES[xh.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ssd_fwd launch failed: {lib.ssd_fwd_error_string(err).decode()} (cudaError {err})"
        )
    launches += 1
    return y, state
