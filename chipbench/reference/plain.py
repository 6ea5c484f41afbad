"""The equations every reference family shares, in plain float32 PyTorch.

Nothing here imports the program under test.  Each function takes float32
tensors and a ``mm`` (a matrix product): ``exact_mm`` is the reference,
``fp8_mm`` the control, which rounds both operands of every product to
float8 e4m3 with one scale per row (activations) or per column (weights),
the step below the bfloat16 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

FP8_MAX = 448.0  # the largest float8 e4m3 value


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax of the slice maps to 448), back in float32.  The rounding is
    passed straight through in the backward pass."""
    scale = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``a`` rounded per row and ``b`` per column."""
    return fp8_round(a, -1) @ fp8_round(b, -2)


def set_exact_float32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, heads, hd) at positions 0..S-1: the first
    and second halves of each head are the pairs rotated."""
    S, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mm: Matmul,
                     q_block: int = 1024) -> torch.Tensor:
    """Softmax attention of one sequence: q (S, H, hd), k and v (S, K, hd),
    each of the K key heads shared by H / K query heads; query i sees keys
    0..i.  Returns (S, H, hd).  Query rows go in blocks of ``q_block``."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # (H, S, hd)
    vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) / math.sqrt(hd)
    out = []
    for lo in range(0, S, q_block):
        hi = min(lo + q_block, S)
        s = mm(qh[:, lo:hi], kh[:, :hi].transpose(1, 2))  # (H, hi - lo, hi)
        keep = torch.arange(hi, device=q.device)[None, :] <= torch.arange(lo, hi, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        out.append(mm(p, vh[:, :hi]))
    return torch.cat(out, dim=1).transpose(0, 1)


def attention_block(w: dict, x: torch.Tensor, theta: float, mm: Matmul) -> torch.Tensor:
    """Grouped-query attention of one sequence x (S, d) with weights wq (d,
    H, hd), wk and wv (d, K, hd), wo (H, hd, d); rotary on q and k."""
    S, d = x.shape
    _, H, hd = w["wq"].shape
    K = w["wk"].shape[1]
    q = mm(x, w["wq"].reshape(d, H * hd)).view(S, H, hd)
    k = mm(x, w["wk"].reshape(d, K * hd)).view(S, K, hd)
    v = mm(x, w["wv"].reshape(d, K * hd)).view(S, K, hd)
    ctx = causal_attention(rope(q, theta), rope(k, theta), v, mm)
    return mm(ctx.reshape(S, H * hd), w["wo"].reshape(H * hd, d))


def glu_mlp(w: dict, x: torch.Tensor, act: str, mm: Matmul) -> torch.Tensor:
    """act(x wi) * (x wg), then wo; gelu is gelu's tanh form."""
    a = mm(x, w["wi"])
    a = F.silu(a) if act == "silu_glu" else F.gelu(a, approximate="tanh")
    return mm(a * mm(x, w["wg"]), w["wo"])


def token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross-entropy of logits (T, V) against targets (T,)."""
    return (torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[:, None])[:, 0]).sum()
