"""Plain PyTorch version of the SSD kernel's function.

Counterpart of ``repro.kernels.ssd.ref.ssd_reference``: the Mamba2 selective
state-space recurrence from a zero state, step by step in float32 (in
float64 for float64 inputs),

    h_t = exp(la_t) h_{t-1} + B_t ⊗ xw_t,    y_t = C_t · h_t,

with head ``h`` reading B/C group ``h // (H / G)``.  The wrapper in
``ops.py`` uses it for tensors on the CPU, and ``chip_smoke.py`` holds the
CUDA kernel against it on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_reference(
    xw: torch.Tensor,  # (B, H, S, P) dt-weighted inputs
    la: torch.Tensor,  # (B, H, S, 1) per-step log decay (dt * A)
    bm: torch.Tensor,  # (B, G, S, N)
    cm: torch.Tensor,  # (B, G, S, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-major oracle.  Returns (y (B, H, S, P), final state (B, H, N, P)),
    both float32, or float64 if ``xw`` is."""
    B, H, S, P = xw.shape
    G, N = bm.shape[1], bm.shape[3]
    acc = torch.promote_types(xw.dtype, torch.float32)
    bh = bm.to(acc).repeat_interleave(H // G, dim=1)
    ch = cm.to(acc).repeat_interleave(H // G, dim=1)
    xf = xw.to(acc)
    laf = la.to(acc)[..., 0]
    h = torch.zeros((B, H, N, P), dtype=acc, device=xw.device)
    ys = []
    for t in range(S):
        a = torch.exp(laf[:, :, t])  # (B, H)
        h = h * a[..., None, None] + bh[:, :, t][..., None] * xf[:, :, t][:, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, :, t], h))
    return torch.stack(ys, dim=2), h
