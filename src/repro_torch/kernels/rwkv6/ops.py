"""Public wrapper for the RWKV6 chunked-scan kernel (counterpart of
``repro.kernels.rwkv6.ops.rwkv6_mix``).

Takes the model's ``(B, S, H, P)`` layout and returns the output in it,
with the final state head-major, as the JAX wrapper does.  A CUDA tensor
goes to the hand-written tensor-core kernel ``csrc/rwkv6_fwd_sm90.cu`` (TMA
and split-TF32 ``wgmma``, built at first use), which reads the model layout
directly, so no transposes run around the launch; a CPU tensor goes to the
plain PyTorch version in ``ref.py``.  There is no fallback from one to the
other: on the card the kernel runs or the call raises.  ``launches`` counts
kernel launches (plain-version calls are not counted).

The kernel reads r, k, v in float32 or bfloat16 as given (bfloat16 converts
exactly), logw and u in float32.  A head dim that TMA's 16-byte strides
cannot take (a multiple of 4 in float32, of 8 in bfloat16) is padded with
zeros, which add nothing to the output or the state.  It runs chunks of 64
steps whatever ``chunk`` is, since the result does not depend on the chunk
length; ``chunk`` is checked as the JAX wrapper checks it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_autograd

from .ref import rwkv6_reference

# Kernel launches since the counter was last reset (chip_smoke.py sets it to
# 0 before it drives the main path).
launches = 0

MAX_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}  # 16-byte TMA strides


@lru_cache(maxsize=None)
def _kernel():
    from repro_torch.kernels import _build

    return bind(_build.library("rwkv6_fwd_sm90"))


def bind(lib):
    """Declare the C signatures of a loaded ``rwkv6_fwd_sm90`` library (the
    built kernel, or a variant of it built by ``tools/rwkv6_sm90_ablate.py``)."""
    fn = lib.rwkv6_fwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rwkv6_fwd_sm90_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_fwd_sm90_error_string.restype = ctypes.c_char_p
    for name in ("rwkv6_fwd_sm90_smem_bytes", "rwkv6_fwd_sm90_blocks_per_sm"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(r, k, v, logw, u, Q):
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError("expected r, k, v, logw (B,S,H,P) and u (H,P)")
    B, S, H, P = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape or u.shape != (H, P):
        raise ValueError(
            f"shapes do not match: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"logw {tuple(logw.shape)}, u {tuple(u.shape)}"
        )
    if S % Q:
        raise ValueError(f"sequence length {S} must be a multiple of the chunk {Q}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if len({t.device for t in (r, k, v, logw, u)}) != 1:
        raise ValueError("r, k, v, logw, u must lie on one device")


def rwkv6_mix(
    r: torch.Tensor,  # (B, S, H, P)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, S, H, P) log decay <= 0
    u: torch.Tensor,  # (H, P)
    *,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV scan from a zero state.  Returns (out (B, S, H, P) f32, final
    state (B, H, P, P) f32).  ``Q = min(chunk, S)`` and ``S % Q == 0``, as
    in the JAX wrapper."""
    global launches
    S = r.shape[1]
    Q = min(chunk, S)
    _check(r, k, v, logw, u, Q)
    refuse_autograd("rwkv6_mix", r, k, v, logw, u)
    if r.device.type == "cpu":
        tr = lambda t: t.transpose(1, 2)
        out, state = rwkv6_reference(tr(r), tr(k), tr(v), tr(logw), u)
        return tr(out), state
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_mix runs on cuda or cpu, not {r.device}")
    B, S, H, P = r.shape
    if P > MAX_HEAD_DIM:
        raise NotImplementedError(f"head dim {P} above the kernel's {MAX_HEAD_DIM}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share a dtype; got {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    r, k, v, logw, u = kernel_inputs(r, k, v, logw, u)
    P4 = r.shape[3]
    out = torch.empty((B, S, H, P4), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, P4, P4), dtype=torch.float32, device=r.device)
    lib = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_fwd_sm90(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            out.data_ptr(), state.data_ptr(), B, S, H, P4, _DTYPE_CODES[r.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"rwkv6_fwd_sm90 launch failed: {lib.rwkv6_fwd_sm90_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    launches += 1
    if P4 != P:
        out, state = out[..., :P].contiguous(), state[:, :, :P, :P].contiguous()
    return out, state


def kernel_inputs(r, k, v, logw, u):
    """r, k, v, logw, u as the kernel reads them: logw and u in float32, the
    head dim padded with zeros to what TMA's 16-byte strides take (a copy
    only where it must be padded)."""
    pad = -r.shape[3] % _HEAD_DIM_MULTIPLE[r.dtype]
    logw, u = logw.float(), u.float().contiguous()
    if pad:
        r, k, v, logw, u = (F.pad(t, (0, pad)) for t in (r, k, v, logw, u))
    return r, k, v, logw, u
