"""Plain PyTorch version of the flash attention kernel's function.

Counterpart of ``repro.kernels.attention.ref.attention_reference``: causal /
sliding-window GQA softmax attention computed in float32 (in float64 for
float64 inputs) over the full score matrix.  The wrapper in ``ops.py`` uses
it for tensors on the CPU, and ``chip_smoke.py`` holds the CUDA kernels
against it on the card.

``attention_split_tf32_reference`` follows the float32 CUDA kernel's
arithmetic (``csrc/flash_fwd_tf32_sm90.cu``) tile by tile, with its operand
rounding, for the tests: it is never on a serving path.

``attention_stats_reference`` and ``attention_backward_reference`` are the
plain versions of the training path (``ops.FlashAttention``): the causal
forward with each row's log-sum-exp, and the gradient from them, block by
block with the backward kernels' arithmetic (``csrc/flash_bwd_sm90.cu``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.tf32 import product

NEG_INF = -1e30
LOG2E = 1.4426950408889634
TILE_ROWS, TILE_KEYS = 64, 32  # the float32 kernel's consumer warpgroup rows and KV tile keys


def _mask(rows: torch.Tensor, cols: torch.Tensor, S: int, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """Which (row, col) pairs attend: keys below S, at or before the query
    under causal masking, and fewer than ``window`` positions back."""
    keep = (cols < S)[None, :].expand(len(rows), -1)
    if causal:
        keep = keep & (rows[:, None] >= cols[None, :])
    if window is not None:
        keep = keep & (rows[:, None] < cols[None, :] + window)
    return keep


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
    acc = torch.promote_types(q.dtype, torch.float32)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc) * scale, k.to(acc))
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(~_mask(pos, pos, S, causal, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc))
    return out.to(q.dtype)


def attention_split_tf32_reference(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, K, S, hd)
    v: torch.Tensor,  # (B, K, S, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    tf32: Optional[str] = "split",
    pv_tf32: Optional[str] = "split",
) -> torch.Tensor:
    """The float32 kernel's arithmetic, head-major, in float32: q scaled by
    1/sqrt(hd); for each block of 64 q rows (a consumer warpgroup's), the
    tiles of 32 keys live for those rows (none above the causal
    diagonal, none wholly below the window; keys zero-padded past S), each
    with S = Q.K^T, masked scores set to -1e30 and the rest scaled by
    log2(e), the online softmax update in base 2 and O += P.V; the final
    divide clamps l at 1e-30.  ``tf32`` (Q.K^T) and ``pv_tf32`` (P.V) round
    the products' operands as the kernel's wgmma does (``kernels/tf32.py``):
    ``"split"`` is the kernel (hi.hi + hi.lo + lo.hi; the term it drops is
    lo.lo), ``"one"`` one TF32 product (hi.hi), ``"split_no_hl"`` /
    ``"split_no_lh"`` the split without hi.lo / lo.hi, ``None`` exact
    float32 operands.  Returns (B, H, S, hd) float32."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    rows, keys = TILE_ROWS, TILE_KEYS
    pad = -S % keys
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad)).repeat_interleave(G, dim=1)
              for t in (k, v))
    qs = q.float() * (1.0 / math.sqrt(hd))
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    for r0 in range(0, S, rows):
        r1 = min(r0 + rows, S)
        rows_pos = torch.arange(r0, r1, device=q.device)
        hi = (S + keys - 1) // keys - 1
        if causal:
            hi = min(hi, (r1 - 1) // keys)
        lo = (r0 - window + 1) // keys if window is not None and r0 - window + 1 > 0 else 0
        m = torch.full((B, H, r1 - r0, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, H, r1 - r0, 1), device=q.device)
        acc = torch.zeros((B, H, r1 - r0, hd), device=q.device)
        for j in range(lo, hi + 1):
            cols = torch.arange(j * keys, (j + 1) * keys, device=q.device)
            s = product(qs[:, :, r0:r1], kf[:, :, cols].transpose(-1, -2), tf32)
            s = torch.where(_mask(rows_pos, cols, S, causal, window), s * LOG2E, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + product(p, vf[:, :, cols], pv_tf32)
            m = m_new
        out[:, :, r0:r1] = acc / l.clamp(min=1e-30)
    return out


def attention_stats_reference(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, K, S, hd)
    v: torch.Tensor,  # (B, K, S, hd)
    *,
    blk: int = 256,
):
    """Causal GQA attention and each row's log-sum-exp of the scaled
    scores (natural log), block by block of ``blk`` q rows against every
    key, in float32 (float64 for float64 inputs).  Returns (out in q's
    dtype, lse (B, H, S) in the computing type)."""
    B, H, S, hd = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    G = H // k.shape[1]
    kf, vf = (t.to(acc).repeat_interleave(G, dim=1) for t in (k, v))
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=acc, device=q.device)
    pos = torch.arange(S, device=q.device)
    for r0 in range(0, S, blk):
        rows = pos[r0 : r0 + blk]
        s = (q[:, :, r0 : r0 + blk].to(acc) @ kf.transpose(-1, -2)) * scale
        s = s.masked_fill(~_mask(rows, pos, S, True, None), NEG_INF)
        lse[:, :, r0 : r0 + blk] = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[:, :, r0 : r0 + blk, None])
        out[:, :, r0 : r0 + blk] = (p @ vf).to(q.dtype)
    return out, lse


def split_hi_lo(x: torch.Tensor, dtype: torch.dtype):
    """``x`` as two terms in ``dtype``: hi = x rounded to ``dtype`` and lo =
    the rest rounded to ``dtype`` (in bf16, 16 significant bits of x; in
    float32 or float64 inputs' own type, hi = x and lo = 0)."""
    hi = x.to(dtype)
    return hi, (x - hi.to(x.dtype)).to(dtype)


def attention_backward_reference(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, K, S, hd)
    v: torch.Tensor,  # (B, K, S, hd)
    out: torch.Tensor,  # (B, H, S, hd), the forward's output
    lse: torch.Tensor,  # (B, H, >= S), the forward's log-sum-exp
    dout: torch.Tensor,  # (B, H, S, hd)
    *,
    blk: int = 64,
):
    """(dq, dk, dv) of causal GQA attention, in the inputs' dtypes, block by
    block of ``blk`` keys, with the backward kernels' arithmetic in float32
    (float64 for float64 inputs): D = rowsum(dout * out); for each block, S
    and dP = dout.V^T from the operands as they are, P = exp(S - lse)
    (0 above the diagonal), dS = P * (dP - D); dV = P^T.dout with P rounded
    to q's dtype; dQ = dS.K and dK = dS^T.Q with dS as two terms in q's
    dtype (``split_hi_lo``), both scaled by 1/sqrt(hd); the query heads'
    dK and dV summed onto their KV head.  For float32 or float64 inputs no
    operand is rounded: the exact blocked backward."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G = H // K
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(hd)
    qf, of, dof = (t.to(acc) for t in (q, out, dout))
    kf, vf = (t.to(acc).repeat_interleave(G, dim=1) for t in (k, v))
    lse = lse[:, :, :S, None].to(acc)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    dq = torch.zeros((B, H, S, hd), dtype=acc, device=q.device)
    dk = torch.empty((B, H, S, hd), dtype=acc, device=q.device)
    dv = torch.empty((B, H, S, hd), dtype=acc, device=q.device)
    pos = torch.arange(S, device=q.device)
    for c0 in range(0, S, blk):
        cols = slice(c0, c0 + blk)
        s = (qf @ kf[:, :, cols].transpose(-1, -2)) * scale
        keep = _mask(pos, pos[cols], S, True, None)
        p = torch.where(keep, torch.exp(s - lse), 0.0)
        ds = p * (dof @ vf[:, :, cols].transpose(-1, -2) - delta)
        dv[:, :, cols] = p.to(q.dtype).to(acc).transpose(-1, -2) @ dof
        hi, lo = (t.to(acc) for t in split_hi_lo(ds, q.dtype))
        dq += (hi @ kf[:, :, cols] + lo @ kf[:, :, cols]) * scale
        dk[:, :, cols] = (hi.transpose(-1, -2) @ qf + lo.transpose(-1, -2) @ qf) * scale
    dk, dv = (t.view(B, K, G, S, hd).sum(dim=2) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
