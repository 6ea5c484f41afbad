"""Plain PyTorch version of the flash attention kernel's function.

Counterpart of ``repro.kernels.attention.ref.attention_reference``: causal /
sliding-window GQA softmax attention computed in float32 over the full score
matrix.  The wrapper in ``ops.py`` uses it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, K, S, hd)
    v: torch.Tensor,  # (B, K, S, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, H, S, hd = q.shape
    K = k.shape[1]
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    pos_q = torch.arange(S, device=q.device)[:, None]
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q < pos_k + window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
