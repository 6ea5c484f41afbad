"""Plain PyTorch version of the RWKV6 kernel's function.

Counterpart of ``repro.kernels.rwkv6.ref.rwkv6_reference``: the WKV
recurrence with per-channel decay and the ``u`` bonus, from a zero state,
step by step in float32 (in float64 for float64 inputs),

    o_t = r_t · (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T.

The wrapper in ``ops.py`` uses it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

``rwkv6_subchunk_reference`` follows the CUDA kernel's decomposition
(``csrc/rwkv6_fwd_sm90.cu``) step by step, with its operand rounding, for
the tests: it is never on a serving path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.tf32 import product as _product
from repro_torch.kernels.tf32 import split as _split


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


LOG2E = 1.4426950408889634


def rwkv6_subchunk_reference(
    r: torch.Tensor,  # (B, H, S, P)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, H, S, P) log decay <= 0
    u: torch.Tensor,  # (H, P)
    *,
    chunk: int = 64,
    sub: int = 16,
    tf32: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV scan in the CUDA kernel's decomposition, head-major, in
    float32: chunks of ``chunk`` steps (zero-filled past S: r = k = v = 0,
    logw = 0), C = log2(e) cumsum(logw) per chunk, anchors A_m = C at the end
    of sub-chunk m - 1 (A_0 = 0); off-diagonal score blocks as products of
    rho = r 2^{C_{t-1} - A_i} times X_{i,j+1} = 2^{A_i - A_{j+1}} (rows at or
    before the anchor zeroed) with kt = k 2^{A_{j+1} - C}; the diagonal
    ``sub`` x ``sub`` blocks in the direct form with the u bonus; the
    inter-chunk operand rho X_{i,0}; the state update with kt X_{NSUB,j+1}
    (k 2^{C_L - C} in the last sub-chunk).  ``tf32`` rounds the operands of
    every product as the kernel's wgmma does (see ``kernels/tf32.py``).  Returns (out
    (B, H, S, P), final state (B, H, P, P)), float32."""
    B, H, S, P = r.shape
    if chunk % sub:
        raise ValueError(f"chunk {chunk} must be a multiple of the sub-chunk {sub}")
    ns = chunk // sub
    r, k, v, lw = (t.float() for t in (r, k, v, logw))
    u = u.float()
    pad = -S % chunk
    if pad:
        r, k, v, lw = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (r, k, v, lw))
    blk = torch.arange(chunk, device=r.device) // sub  # sub-chunk of each step
    strict = torch.ones(sub, sub, dtype=torch.bool, device=r.device).tril(-1)  # s < t
    eye = torch.eye(sub, dtype=torch.bool, device=r.device)
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, S + pad, chunk):
        rc, kc, vc, lwc = (t[:, :, c0:c0 + chunk] for t in (r, k, v, lw))
        cl = torch.cumsum(lwc, dim=2) * LOG2E
        cm1 = torch.nn.functional.pad(cl[:, :, :-1], (0, 0, 1, 0))  # C_{t-1}, 0 at t = 0
        anc = torch.cat([torch.zeros_like(cl[:, :, :1]), cl[:, :, sub - 1::sub]], dim=2)
        a_row = anc[:, :, blk]  # A_{i(t)}
        rho = rc * torch.exp2(cm1 - a_row)
        kt = kc * torch.exp2(anc[:, :, blk + 1] - cl)

        def x_row(m):  # X_{i(t), m} per row, 0 where i(t) < m
            keep = (blk >= m)[None, None, :, None]
            return torch.where(keep, torch.exp2((a_row - anc[:, :, m:m + 1]).clamp(max=0)), 0.0)

        o = _product(rho * x_row(0), state, tf32)
        score = torch.zeros((B, H, chunk, chunk), dtype=torch.float32, device=r.device)
        for j in range(ns - 1):
            rows = (blk > j)[None, None, :, None]
            a = torch.where(rows, rho * x_row(j + 1), 0.0)
            cols = slice(j * sub, (j + 1) * sub)
            score[..., cols] = _product(a, kt[:, :, cols].transpose(-1, -2), tf32)
        for i in range(ns):
            sl = slice(i * sub, (i + 1) * sub)
            d = cm1[:, :, sl, None, :] - cl[:, :, None, sl, :]  # (B, H, t, s, P)
            e = torch.where(strict[None, None, :, :, None], torch.exp2(d.clamp(max=0)), 0.0)
            blk_score = torch.einsum("bhtp,bhsp,bhtsp->bhts", rc[:, :, sl], kc[:, :, sl], e)
            bonus = torch.einsum("bhtp,hp,bhtp->bht", rc[:, :, sl], u, kc[:, :, sl])
            score[:, :, sl, sl] = blk_score + torch.where(eye, bonus[..., None], 0.0)
        outs.append(o + _product(score, vc, tf32))
        kq = kt if tf32 is None else sum(_split(kt))  # the kernel reads kt back as hi + lo
        khat = torch.where(
            (blk < ns - 1)[None, None, :, None],
            kq * torch.exp2(anc[:, :, ns:ns + 1] - anc[:, :, (blk + 1).clamp(max=ns)]),
            kc * torch.exp2(cl[:, :, -1:] - cl),
        )
        state = state * torch.exp2(anc[:, :, ns])[..., None] + _product(
            khat.transpose(-1, -2), vc, tf32
        )
    return torch.cat(outs, dim=2)[:, :, :S], state
