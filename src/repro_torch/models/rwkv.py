"""RWKV6 "Finch" blocks (arXiv:2404.05892): attention-free time mix with
data-dependent per-channel decay, plus squared-ReLU channel mix (counterpart
of ``repro.models.rwkv``, with its simplifications: static token-shift
mixes, and the Finch low-rank decay w_t = exp(-exp(w0 + tanh(x W_a) W_b))).

The sequence mix
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
is computed in chunked form, with every exponent a difference that is <= 0
(the direct (Q, Q, P) form; the factorised e^{clw} e^{-clw} form overflows
under strong decay).

Scan paths (``impl``):
* ``torch``  — ``_chunked_wkv``, the counterpart of the JAX model's chunked
               form, with an initial state and logw=0 padding;
* ``kernel`` — a full-sequence call from a zero state goes to
               ``kernels.rwkv6.ops.rwkv6_mix`` (the hand-written CUDA kernel;
               its plain version on the CPU), with r, k, v in the activation
               type (the kernel converts bfloat16 exactly) and logw in
               float32.  A call with a carried state (one-token decode)
               always takes the torch path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .layers import apply_norm, dense_init, init_norm, pad_seq, scan_on_shards
from .transformer import _torch_dtype, residual

Params = Dict[str, torch.Tensor]


def init_time_mix(gen: torch.Generator, cfg: ArchConfig, dtype, device, lead=()) -> Params:
    d = cfg.d_model
    H = d // cfg.rwkv.head_dim
    lora = cfg.rwkv.decay_lora
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mix_rkvg": torch.full((*lead, 4, d), 0.5, **f32),  # token-shift mixes
        "wr": dense_init(gen, d, (*lead, d, d), dtype, device),
        "wk": dense_init(gen, d, (*lead, d, d), dtype, device),
        "wv": dense_init(gen, d, (*lead, d, d), dtype, device),
        "wg": dense_init(gen, d, (*lead, d, d), dtype, device),
        "wo": dense_init(gen, d, (*lead, d, d), dtype, device),
        "w0": torch.full((*lead, d), -4.0, **f32),  # base decay (slow)
        "wa": dense_init(gen, d, (*lead, d, lora), torch.float32, device),
        "wb": dense_init(gen, lora, (*lead, lora, d), torch.float32, device),
        "u": torch.randn((*lead, d), generator=gen, **f32) * 0.1,
        "ln_x": torch.ones((*lead, H, cfg.rwkv.head_dim), **f32),  # per-head groupnorm
    }


def init_channel_mix(gen: torch.Generator, cfg: ArchConfig, dtype, device, lead=()) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full((*lead, d), 0.5, dtype=torch.float32, device=device),
        "wk": dense_init(gen, d, (*lead, d, ff), dtype, device),
        "wv": dense_init(gen, ff, (*lead, ff, d), dtype, device),
    }


def token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Shift the sequence right by one; position 0 gets ``prev`` (the decode
    carry)."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _chunked_wkv(r, k, v, logw, u, state0, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV6 sequence mix.

    r, k, v: (B, S, H, P); logw: (B, S, H, P) (log decay, <= 0);
    u: (H, P); state0: (B, H, P, P) mapping key-dim -> value-dim, or None
    for zeros.  Returns (out (B, S, H, P), final state).
    """
    B, S, H, P = r.shape
    if state0 is None:
        state0 = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad with logw=0 (decay 1) and zero r/k/v -> state unaffected
        pad = Q - S % Q
        r, k, v, logw = (pad_seq(t, pad) for t in (r, k, v, logw))
        S = S + pad
    n = S // Q
    mask = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(diagonal=-1)  # s < t
    state = state0
    outs = []
    for c in range(n):
        sl = slice(c * Q, (c + 1) * Q)
        rc, kc, vc, lwc = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        clw = torch.cumsum(lwc, dim=1)  # cumulative log decay inside the chunk
        # decay from the chunk start to just before t: exp(clw_{t-1}) <= 1
        dec_in = torch.exp(clw - lwc)
        o_inter = torch.einsum("bqhp,bhpo->bqho", rc * dec_in, state)
        # intra-chunk, direct form: exponents clw_{t-1} - clw_s <= 0 for s < t
        diff = (clw - lwc)[:, :, None] - clw[:, None, :]  # (B,Q,Q,H,P), t x s
        expdiff = torch.exp(diff.masked_fill(~mask[None, :, :, None, None], float("-inf")))
        scores = torch.einsum("bqhp,bshp,bqshp->bqsh", rc, kc, expdiff)
        # current-token bonus: (r_t ⊙ u ⊙ k_t) v_t
        diag = torch.einsum("bqhp,bqhp->bqh", rc, u[None, None] * kc)
        o_intra = torch.einsum("bqsh,bsho->bqho", scores, vc) + diag[..., None] * vc
        # state' = diag(e^{clw_Q}) state + sum_s (k_s e^{clw_Q - clw_s}) v_s^T
        decay_all = torch.exp(clw[:, -1])  # (B,H,P)
        carry_k = kc * torch.exp(clw[:, -1][:, None] - clw)  # (B,Q,H,P)
        state = state * decay_all[..., None] + torch.einsum("bqhp,bqho->bhpo", carry_k, vc)
        outs.append(o_inter + o_intra)
    return torch.cat(outs, dim=1)[:, :S_orig], state


def _wkv_kernel(r, k, v, logw, u, chunk: int):
    """A zero-state scan through the RWKV6 kernel: pad to a multiple of the
    chunk with logw=0 and zero r/k/v (state unaffected), scan, slice."""
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops

    S = r.shape[1]
    Q = min(chunk, S)
    pad = -S % Q
    if pad:
        r, k, v, logw = (pad_seq(t, pad) for t in (r, k, v, logw))
    out, state = rwkv6_ops.rwkv6_mix(r, k, v, logw, u, chunk=Q)
    return out[:, :S], state


def apply_time_mix(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    prev_token: torch.Tensor,  # (B, d): last token of the previous segment
    state0: Optional[torch.Tensor],  # (B, H, P, P); None: a fresh zero state
    chunk: int = 128,
    impl: str = "torch",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new_state, new_prev_token).  With ``state0`` None and
    ``impl="kernel"`` the sequence mix goes through the RWKV6 kernel."""
    if impl not in ("torch", "kernel"):
        raise ValueError(f"unknown scan impl {impl!r} (torch | kernel)")
    B, S, d = x.shape
    P = cfg.rwkv.head_dim
    H = d // P
    use_kernel = impl == "kernel" and state0 is None
    xs = token_shift(x, prev_token)
    mix = p["mix_rkvg"].to(x.dtype)
    xr = x * mix[0] + xs * (1 - mix[0])
    xk = x * mix[1] + xs * (1 - mix[1])
    xv = x * mix[2] + xs * (1 - mix[2])
    xg = x * mix[3] + xs * (1 - mix[3])
    r = (xr @ p["wr"]).reshape(B, S, H, P)
    k = (xk @ p["wk"]).reshape(B, S, H, P)
    v = (xv @ p["wv"]).reshape(B, S, H, P)
    g = F.silu(xg @ p["wg"])
    # Finch data-dependent decay (f32 for stability)
    dd = torch.tanh(xk.float() @ p["wa"]) @ p["wb"]
    logw = -torch.exp(p["w0"] + dd)  # (B,S,d), <= 0
    logw = logw.reshape(B, S, H, P)
    u = p["u"].reshape(H, P)
    if use_kernel:
        out, state = _wkv_kernel(r, k, v, logw, u, chunk)
    elif hasattr(r, "placements"):  # DTensors (the dry-run): on each rank's batch and head shards
        out, state = scan_on_shards(
            lambda *t: _chunked_wkv(*t, chunk), (r.float(), k.float(), v.float(), logw, u, state0),
            dims=((0, 2),) * 4 + ((None, 0), (0, 1)), out_dims=((0, 2), (0, 1)), H=H,
        )
    else:
        out, state = _chunked_wkv(r.float(), k.float(), v.float(), logw, u, state0, chunk)
    # per-head group norm
    mean = out.mean(-1, keepdim=True)
    var = ((out - mean) ** 2).mean(-1, keepdim=True)
    out = (out - mean) * torch.rsqrt(var + 1e-5) * p["ln_x"]
    out = out.reshape(B, S, d).to(x.dtype) * g
    return out @ p["wo"], state, x[:, -1, :]


def apply_channel_mix(
    p: Params, x: torch.Tensor, prev_token: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    xs = token_shift(x, prev_token)
    mix = p["mix_k"].to(x.dtype)
    xk = x * mix + xs * (1 - mix)
    h = torch.square(F.relu(xk @ p["wk"]))
    return h @ p["wv"], x[:, -1, :]


def init_rwkv_block(gen: torch.Generator, cfg: ArchConfig, dtype, device, lead=()) -> Params:
    return {
        "norm1": init_norm(cfg, device, lead=lead),
        "time_mix": init_time_mix(gen, cfg, dtype, device, lead=lead),
        "norm2": init_norm(cfg, device, lead=lead),
        "channel_mix": init_channel_mix(gen, cfg, dtype, device, lead=lead),
    }


def apply_rwkv_block(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]],
    chunk: int = 32,
    impl: str = "torch",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """state: {"wkv": (B,H,P,P), "shift_t": (B,d), "shift_c": (B,d)}, or
    None for a fresh zero state (a full-sequence pass).  ``chunk=32`` here
    while ``apply_time_mix`` defaults to 128, as in the JAX package."""
    fresh = state is None
    if fresh:
        state = init_rwkv_state(cfg, x.shape[0], x.device)
    h = apply_norm(p["norm1"], x, cfg)
    out, wkv, shift_t = apply_time_mix(
        p["time_mix"], h, cfg, state["shift_t"], None if fresh else state["wkv"], chunk, impl
    )
    x = residual(x + out)
    h = apply_norm(p["norm2"], x, cfg)
    out, shift_c = apply_channel_mix(p["channel_mix"], h, state["shift_c"])
    x = x + out
    return x, {"wkv": wkv, "shift_t": shift_t, "shift_c": shift_c}


def init_rwkv_state(cfg: ArchConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    P = cfg.rwkv.head_dim
    H = d // P
    dtype = _torch_dtype(cfg.activation_dtype)
    return {
        "wkv": torch.zeros((batch, H, P, P), dtype=torch.float32, device=device),
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def reference_wkv(r, k, v, logw, u, state0):
    """O(S) sequential oracle for tests: the direct recurrence (model
    layout, with an initial state).  Returns (out (B, S, H, P), final
    state)."""
    S = r.shape[1]
    state = state0
    outs = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], torch.exp(logw[:, t])
        att = state + u[None, :, :, None] * kt[..., None] * vt[..., None, :]
        outs.append(torch.einsum("bhp,bhpo->bho", rt, att))
        state = state * wt[..., None] + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, dim=1), state
