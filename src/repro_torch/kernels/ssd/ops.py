"""Public wrapper for the SSD chunked-scan kernel (counterpart of
``repro.kernels.ssd.ops.ssd_scan``).

Takes the model's ``(B, S, ...)`` layout and returns ``y`` in it, with the
final state head-major, as the JAX wrapper does.  A CUDA tensor goes to the
hand-written tensor-core kernel ``csrc/ssd_fwd_sm90.cu`` (TMA and split-TF32
``wgmma``, built at first use), which reads the model layout through
(batch, sequence) strides, so no transposes run around the launch; a CPU
tensor goes to the plain PyTorch version in ``ref.py``.  There is no
fallback from one to the other: on the card the kernel runs or the call
raises.  ``launches`` counts kernel launches (plain-version calls are not
counted).

The kernel reads float32: bfloat16 x, B and C are cast first, and a head or
state dim that is no multiple of 4 (TMA's 16-byte strides) is padded with
zeros, which add nothing to y or the state (``kernel_inputs``).  It runs
chunks of 64 steps whatever ``chunk`` is, since the result does not depend
on the chunk length; ``chunk`` is checked as the JAX wrapper checks it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_autograd

from .ref import ssd_reference

# Kernel launches since the counter was last reset (chip_smoke.py sets it to
# 0 before it drives the main path).
launches = 0

MAX_STATE_DIM = 64
MAX_HEAD_DIM = 64
_DTYPES = (torch.float32, torch.bfloat16)


@lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    return bind(_build.library("ssd_fwd_sm90"))


def bind(lib):
    """Declare the C signatures of a loaded ``ssd_fwd_sm90`` library (the
    built kernel, or a variant of it built by ``tools/ssd_sm90_ablate.py``)."""
    fn = lib.ssd_fwd_sm90
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.ssd_fwd_sm90_error_string.argtypes = [ctypes.c_int]
    lib.ssd_fwd_sm90_error_string.restype = ctypes.c_char_p
    lib.ssd_fwd_sm90_smem_bytes.argtypes = []
    lib.ssd_fwd_sm90_smem_bytes.restype = ctypes.c_int
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
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if len({t.device for t in (xh, dt, A, bm, cm)}) != 1:
        raise ValueError("xh, dt, A, bm, cm must lie on one device")


def _tma_ready(t: torch.Tensor) -> bool:
    """(B, S, mid, inner) float32 with packed (mid, inner), 16-byte aligned,
    and batch / sequence strides in whole 16-byte units."""
    return (t.stride(3) == 1 and (t.shape[2] == 1 or t.stride(2) == t.shape[3])
            and t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0)


def kernel_inputs(xh, bm, cm):
    """x, B, C as the kernel reads them: float32, the head and state dims
    padded with zeros to multiples of 4, strides TMA can take (a copy only
    where a tensor is not so already)."""
    P, N = xh.shape[3], bm.shape[3]
    out = []
    for t, pad in ((xh, -P % 4), (bm, -N % 4), (cm, -N % 4)):
        t = t.float()
        if pad:
            t = F.pad(t, (0, pad))
        if not _tma_ready(t):
            t = t.contiguous()
        out.append(t)
    return out


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
    refuse_autograd("ssd_scan", xh, dt, A, bm, cm)
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
    if N > MAX_STATE_DIM or P > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"state dim {N} / head dim {P} above the kernel's {MAX_STATE_DIM} / {MAX_HEAD_DIM}"
        )
    if bm.dtype != xh.dtype or cm.dtype != xh.dtype:
        raise TypeError(f"xh, bm, cm must share a dtype; got {xh.dtype}, {bm.dtype}, {cm.dtype}")
    # Inside a row the kernel needs the (H, P) and (G, N) elements packed (a
    # stride of a size-1 dim is never used).
    for name, t in (("xh", xh), ("bm", bm), ("cm", cm)):
        inner = t.shape[3]
        if (inner > 1 and t.stride(3) != 1) or (t.shape[2] > 1 and t.stride(2) != inner):
            raise ValueError(f"{name} must be packed in its last two dims")
    x4, b4, c4 = kernel_inputs(xh, bm, cm)
    P4, N4 = x4.shape[3], b4.shape[3]
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    y = torch.empty((B, S, H, P4), dtype=torch.float32, device=xh.device)
    state = torch.empty((B, H, N4, P4), dtype=torch.float32, device=xh.device)
    lib = _kernel()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.ssd_fwd_sm90(
            x4.data_ptr(), dt.data_ptr(), A.data_ptr(), b4.data_ptr(), c4.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            B, S, H, P4, G, N4,
            x4.stride(0), x4.stride(1), b4.stride(0), b4.stride(1), c4.stride(0), c4.stride(1),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ssd_fwd_sm90 launch failed: {lib.ssd_fwd_sm90_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    launches += 1
    if P4 != P or N4 != N:
        y, state = y[..., :P].contiguous(), state[:, :, :N, :P].contiguous()
    return y, state
