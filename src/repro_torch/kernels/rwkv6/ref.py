"""Plain PyTorch version of the RWKV6 kernel's function.

Counterpart of ``repro.kernels.rwkv6.ref.rwkv6_reference``: the WKV
recurrence with per-channel decay and the ``u`` bonus, from a zero state,
step by step in float32 (in float64 for float64 inputs),

    o_t = r_t · (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T.

The wrapper in ``ops.py`` uses it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rwkv6_reference(
    r: torch.Tensor,  # (B, H, S, P)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, H, S, P) log decay <= 0
    u: torch.Tensor,  # (H, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-major oracle.  Returns (out (B, H, S, P), final state
    (B, H, P, P)), both float32, or float64 if ``r`` is."""
    B, H, S, P = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, lw, uf = (t.to(acc) for t in (r, k, v, logw, u))
    state = torch.zeros((B, H, P, P), dtype=acc, device=r.device)
    outs = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], torch.exp(lw[:, :, t])
        kv = kt[..., None] * vt[..., None, :]
        att = state + uf[None, :, :, None] * kv
        outs.append(torch.einsum("bhp,bhpo->bho", rt, att))
        state = state * wt[..., None] + kv
    return torch.stack(outs, dim=2), state
