"""Mamba2 (SSD) blocks, the state-space backbone of Zamba2 (counterpart of
``repro.models.mamba2``).

The selective SSM
    h_t = exp(A * dt_t) h_{t-1} + dt_t * B_t ⊗ x_t,    y_t = C_t · h_t + D * x_t
is evaluated chunk-parallel, as in the JAX package: inside a chunk of Q
steps the causal decay L[t,s] = exp(cla_t - cla_s) turns the recurrence into
two products, and a small (H, N, P) state carries across chunks.

Scan paths (``impl``):
* ``torch``  — ``ssd_chunked``, the counterpart of the JAX model's chunked
               scan, with an initial state and dt=0 padding;
* ``kernel`` — a full-sequence call from a zero state goes to
               ``kernels.ssd.ops.ssd_scan`` (the hand-written CUDA kernel;
               its plain version on the CPU).  A call with a carried state
               (one-token decode) always takes the torch path.

Block structure: in_proj -> [z | x | B | C | dt], causal depthwise conv on
(x, B, C), SSD, gated (silu(z)) RMSNorm, out_proj.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .layers import dense_init, pad_seq, scan_on_shards

Params = Dict[str, torch.Tensor]


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, state_dim)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.head_dim, s.state_dim


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype, device, lead=()) -> Params:
    """One Mamba2 mixer's parameters (stacked on ``lead``), with the JAX
    leaf names and shapes."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    G = s.n_groups
    proj_out = 2 * d_in + 2 * G * N + H  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((*lead, s.conv_width, d_in + 2 * G * N), generator=gen, **f32) * 0.1
    return {
        "in_proj": dense_init(gen, d, (*lead, d, proj_out), dtype, device),
        "conv_w": conv_w,
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(*lead, H).clone(),
        "D": torch.ones((*lead, H), **f32),
        "dt_bias": torch.full((*lead, H), math.log(math.expm1(1e-2)), **f32),
        "norm": torch.ones((*lead, d_in), **f32),  # gated RMSNorm scale
        "out_proj": dense_init(gen, d_in, (*lead, d_in, d), dtype, device),
    }


def causal_conv(
    x: torch.Tensor, w: torch.Tensor, state: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B,S,C), w: (K,C), state: (B,K-1,C).
    Returns (silu(conv) in the promoted dtype, new state in x's dtype)."""
    K = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1) :, :] if K > 1 else state
    return F.silu(out), new_state


def ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P) inputs per head
    dt: torch.Tensor,  # (B, S, H) positive step sizes
    A: torch.Tensor,  # (H,) negative decay rates
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    state0: Optional[torch.Tensor],  # (B, H, N, P); None: zeros
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Heads are assigned to B/C groups round-robin.
    Returns (y (B, S, H, P), final state (B, H, N, P))."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if state0 is None:
        state0 = torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad with dt=0 steps: decay 1, zero input -> state unaffected
        pad = Q - S % Q
        xh, dt, Bm, Cm = (pad_seq(t, pad) for t in (xh, dt, Bm, Cm))
        S = S + pad
    n = S // Q
    Bh = Bm.repeat_interleave(H // G, dim=2)  # (B,S,H,N)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    la = dt * A  # (B,S,H) log-decay per step (negative)
    xw = xh * dt[..., None]  # dt-weighted input
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()  # s <= t
    state = state0
    ys = []
    for c in range(n):
        sl = slice(c * Q, (c + 1) * Q)
        xc, lac, bc, cc = xw[:, sl], la[:, sl], Bh[:, sl], Ch[:, sl]
        cla = torch.cumsum(lac, dim=1)  # (B,Q,H) cumulative log decay (incl. t)
        # inter-chunk: y_inter[t] = exp(cla_t) * C_t . state
        y_inter = torch.einsum("bqhn,bhnp->bqhp", cc * torch.exp(cla)[..., None], state)
        # intra-chunk: L[t,s] = exp(cla_t - cla_s) for s <= t
        diff = cla[:, :, None, :] - cla[:, None, :, :]  # (B,Q,Q,H)
        L = torch.exp(diff.masked_fill(~mask[None, :, :, None], float("-inf")))
        scores = torch.einsum("bqhn,bshn->bqsh", cc, bc) * L
        y_intra = torch.einsum("bqsh,bshp->bqhp", scores, xc)
        # state' = exp(cla_Q) state + sum_s exp(cla_Q - cla_s) B_s x_s^T
        dec_all = torch.exp(cla[:, -1])  # (B,H)
        carry = torch.exp(cla[:, -1][:, None] - cla)  # (B,Q,H) <= 1
        state = state * dec_all[..., None, None] + torch.einsum(
            "bqhn,bqhp->bhnp", bc * carry[..., None], xc
        )
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)
    return y[:, :S_orig], state


def _ssd_kernel(xh, dt, A, Bm, Cm, chunk: int):
    """A zero-state scan through the SSD kernel: pad to a multiple of the
    chunk with dt=0 steps (state unaffected), scan, slice."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    S = xh.shape[1]
    Q = min(chunk, S)
    pad = -S % Q
    if pad:
        xh, dt, Bm, Cm = (pad_seq(t, pad) for t in (xh, dt, Bm, Cm))
    y, state = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=Q)
    return y[:, :S], state


def apply_mamba2(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "torch",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One Mamba2 mixer.  ``state`` None means a fresh zero state (a
    full-sequence pass); with ``impl="kernel"`` that pass goes through the
    SSD kernel.  Returns (out, new state)."""
    if impl not in ("torch", "kernel"):
        raise ValueError(f"unknown scan impl {impl!r} (torch | kernel)")
    s = cfg.ssm
    B, S, d = x.shape
    d_in, H, P, N = ssm_dims(cfg)
    G = s.n_groups
    use_kernel = impl == "kernel" and state is None
    ssm0 = None if state is None else state["ssm"]
    if state is None:
        state = init_mamba2_state(cfg, B, x.device)
    proj = x @ p["in_proj"]
    z, xs, bm, cm, dt = torch.split(proj, [d_in, d_in, G * N, G * N, H], dim=-1)
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, p["conv_w"], state["conv"])
    xs, bm, cm = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,)
    xh = xs.reshape(B, S, H, P).float()
    bm = bm.reshape(B, S, G, N).float()
    cm = cm.reshape(B, S, G, N).float()

    def scan(xh, dt, A, bm, cm, D, ssm0):
        if use_kernel:
            y, ssm_state = _ssd_kernel(xh, dt, A, bm, cm, s.chunk)
        else:
            y, ssm_state = ssd_chunked(xh, dt, A, bm, cm, ssm0, s.chunk)
        return y + xh * D[None, None, :, None], ssm_state

    args = (xh, dt, A, bm, cm, p["D"], ssm0)
    if hasattr(xh, "placements"):  # DTensors (the dry-run): on each rank's batch and head shards
        dims = ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0), (0, 1))
        y, ssm_state = scan_on_shards(scan, args, dims, out_dims=((0, 2), (0, 1)), H=H)
    else:
        y, ssm_state = scan(*args)
    y = y.reshape(B, S, d_in)
    # gated RMSNorm (Mamba2)
    y = y * F.silu(z.float())
    ms = (y * y).mean(-1, keepdim=True)
    y = (y * torch.rsqrt(ms + 1e-6) * p["norm"]).to(x.dtype)
    return y @ p["out_proj"], {"conv": conv_state, "ssm": ssm_state}


def init_mamba2_state(cfg: ArchConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d_in, H, P, N = ssm_dims(cfg)
    G = s.n_groups
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * G * N), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    }


def reference_ssd(xh, dt, A, Bm, Cm, state0):
    """O(S) sequential oracle for tests (model layout, with an initial
    state).  Returns (y (B, S, H, P), final state)."""
    B, S, H, P = xh.shape
    G = Bm.shape[2]
    Bh = Bm.repeat_interleave(H // G, dim=2)
    Ch = Cm.repeat_interleave(H // G, dim=2)
    h = state0
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])  # (B,H)
        xw = xh[:, t] * dt[:, t][..., None]  # (B,H,P)
        h = h * a[..., None, None] + Bh[:, t][..., None] * xw[:, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1), h
