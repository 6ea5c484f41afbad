"""Exact analytic FLOP / byte accounting per architecture and cell (port
of ``repro.analysis.analytic``, copied verbatim in its arithmetic).

Closed forms of the matmul, attention and scan math of one train step,
prefill or decode step: as compiled (remat recompute, the causal
full-mask waste of the blocked attention path, MoE capacity overhead) and
useful (6ND convention, causal-exact attention), and HBM bytes with bf16
activations and parameters and float32 scan states.  The fleet planner
prices compute and memory time from them; collective bytes are not
modelled here.

Conventions: a matmul of (m, k) x (k, n) costs 2*m*k*n FLOPs.

``ATTN_KV_BLOCK`` and ``RWKV_CHUNK`` are the JAX model stack's blocked
attention block and RWKV chunk, kept as they are so that the planner's
rows equal the JAX planner's; the port's flash kernel tiles differently
and its chunked scans take other chunks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig

BF16 = 2
F32 = 4

# the JAX model stack's defaults (its blocked attention's kv block, its
# RWKV chunk): the planner's parity depends on them
ATTN_KV_BLOCK = 1024
RWKV_CHUNK = 32


@dataclass
class CellCost:
    flops_compiled: float  # as-compiled global FLOPs per step
    flops_useful: float  # model FLOPs (6ND-convention, causal-exact attention)
    bytes_hbm: float  # estimated global HBM traffic per step
    breakdown: Dict[str, float]


def _attn_flops(arch: ArchConfig, B: int, S: int, compiled: bool) -> float:
    """Scores + PV flops for the train/prefill attention over S tokens."""
    H, hd = arch.n_heads, arch.resolved_head_dim
    if arch.sliding_window is not None and S > arch.sliding_window:
        band = min(arch.sliding_window + ATTN_KV_BLOCK, S)
        kv_len = band if compiled else min(arch.sliding_window, S) / 2 + ATTN_KV_BLOCK / 2
    else:
        kv_len = S if compiled else S / 2  # causal: useful is half
    return 2 * 2 * B * S * kv_len * H * hd


def _qkvo_flops(arch: ArchConfig, tokens: float) -> float:
    d, H, K, hd = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    return 2 * tokens * (d * H * hd + 2 * d * K * hd + H * hd * d)


def _mlp_flops(arch: ArchConfig, tokens: float) -> float:
    glu = 3 if arch.mlp_act.endswith("_glu") else 2
    return 2 * tokens * glu * arch.d_model * arch.d_ff


def _moe_flops(arch: ArchConfig, tokens: float, compiled: bool) -> float:
    moe = arch.moe
    glu = 3 if arch.mlp_act.endswith("_glu") else 2
    mult = moe.top_k * (moe.capacity_factor if compiled else 1.0)
    expert = 2 * tokens * mult * glu * arch.d_model * arch.d_ff
    router = 2 * tokens * arch.d_model * moe.num_experts
    return expert + router


def _rwkv_layer_flops(arch: ArchConfig, B: int, S: int) -> float:
    d = arch.d_model
    P = arch.rwkv.head_dim
    H = d // P
    lora = arch.rwkv.decay_lora
    proj = 2 * B * S * 5 * d * d  # r,k,v,g,o
    dd = 2 * B * S * (d * lora + lora * d)
    Q = min(RWKV_CHUNK, S)
    n = math.ceil(S / Q)
    # per chunk per head: scores direct form ~ 3*Q^2*P (mult+exp treated as 1)
    # + scores@v 2*Q^2*P + state in/out 2*2*Q*P^2
    wkv = B * H * n * (3 * Q * Q * P + 2 * Q * Q * P + 4 * Q * P * P)
    cm = 2 * B * S * 2 * arch.d_model * arch.d_ff
    return proj + dd + wkv + cm


def _mamba_layer_flops(arch: ArchConfig, B: int, S: int) -> float:
    s = arch.ssm
    d = arch.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    P, N, G = s.head_dim, s.state_dim, s.n_groups
    proj_out = 2 * d_in + 2 * G * N + H
    proj = 2 * B * S * d * proj_out + 2 * B * S * d_in * d
    Q = min(s.chunk, S)
    n = math.ceil(S / Q)
    # per chunk per head: CB^T 2Q^2N + (scores*L)@x 2Q^2P + state 2*2*Q*N*P
    ssd = B * H * n * (2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * N * P)
    conv = B * S * (d_in + 2 * G * N) * s.conv_width * 2
    return proj + ssd + conv


def _head_flops(arch: ArchConfig, B: int, S: int) -> float:
    return 2 * B * S * arch.d_model * arch.padded_vocab_size * arch.n_codebooks


def forward_flops(arch: ArchConfig, B: int, S: int, compiled: bool = True) -> Dict[str, float]:
    """Per-component forward flops for B sequences of S tokens."""
    tokens = B * S
    L = arch.n_layers
    out: Dict[str, float] = {}
    if arch.family == "ssm" and arch.rwkv is not None:
        out["layers"] = L * _rwkv_layer_flops(arch, B, S)
    elif arch.family == "hybrid":
        out["layers"] = L * _mamba_layer_flops(arch, B, S)
        n_shared = L // arch.shared_attn_every
        shared = (
            _qkvo_flops(arch, tokens)
            + _attn_flops(arch, B, S, compiled)
            + _mlp_flops(arch, tokens)
        )
        out["shared_attn"] = n_shared * shared
    else:
        per = _qkvo_flops(arch, tokens) + _attn_flops(arch, B, S, compiled)
        if arch.moe is not None:
            per += _moe_flops(arch, tokens, compiled)
        else:
            per += _mlp_flops(arch, tokens)
        out["layers"] = L * per
    if arch.frontend == "vlm":
        # patches extend the sequence
        pass  # patch tokens already included if caller adjusts S; keep simple
    out["head"] = _head_flops(arch, B, S)
    return out


def decode_flops(arch: ArchConfig, B: int, cache_len: int) -> Dict[str, float]:
    """One decode step for B sequences against a cache of cache_len."""
    out: Dict[str, float] = {}
    L = arch.n_layers
    H, hd = arch.n_heads, arch.resolved_head_dim
    if arch.family == "ssm" and arch.rwkv is not None:
        out["layers"] = L * _rwkv_layer_flops(arch, B, 1)
    elif arch.family == "hybrid":
        out["layers"] = L * _mamba_layer_flops(arch, B, 1)
        n_shared = L // arch.shared_attn_every
        attn = 2 * 2 * B * 1 * cache_len * H * hd
        out["shared_attn"] = n_shared * (
            _qkvo_flops(arch, B) + attn + _mlp_flops(arch, B)
        )
    else:
        kv = min(cache_len, arch.sliding_window) if arch.sliding_window else cache_len
        attn = 2 * 2 * B * 1 * kv * H * hd
        per = _qkvo_flops(arch, B) + attn
        if arch.moe is not None:
            per += _moe_flops(arch, B, True)
        else:
            per += _mlp_flops(arch, B)
        out["layers"] = L * per
    out["head"] = _head_flops(arch, B, 1)
    return out


# ---------------------------------------------------------------------------
# Bytes (HBM traffic estimates)
# ---------------------------------------------------------------------------
def param_bytes(n_params: float, dtype_bytes: int = BF16) -> float:
    return n_params * dtype_bytes


def train_bytes(arch: ArchConfig, n_params: float, B: int, S: int, microbatches: int) -> float:
    """Weights: read per microbatch in fwd + remat-fwd + bwd, grads written
    per microbatch (f32 accum read+write), optimizer reads/writes m, v,
    params.  Activations: ~12 d-sized streams per layer per token (reads +
    writes through the fused blocks) + attention score traffic."""
    pb = n_params * BF16
    weight_traffic = microbatches * 3 * pb  # fwd + remat + bwd reads
    grad_traffic = microbatches * 2 * n_params * F32 + 2 * n_params * F32
    opt_traffic = n_params * F32 * 4 + n_params * BF16 * 2  # m,v rw + param rw
    act = _activation_bytes(arch, B, S, training=True)
    return weight_traffic + grad_traffic + opt_traffic + act


def _activation_bytes(arch: ArchConfig, B: int, S: int, training: bool) -> float:
    d = arch.d_model
    L = arch.n_layers
    streams = 12 if not training else 30  # fwd vs fwd+remat+bwd
    act = L * B * S * d * BF16 * streams
    # attention scores (chunked: full S^2 traffic in f32 once each way)
    if arch.family not in ("ssm",) and arch.ssm is None:
        H = arch.n_heads
        kv_len = min(arch.sliding_window + ATTN_KV_BLOCK, S) if arch.sliding_window and S > arch.sliding_window else S
        act += L * B * S * kv_len * H * F32 * (2 if not training else 6)
    act += B * S * arch.padded_vocab_size * arch.n_codebooks * BF16 * (2 if training else 1)
    return act


def prefill_bytes(arch: ArchConfig, n_params: float, B: int, S: int) -> float:
    return n_params * BF16 + _activation_bytes(arch, B, S, training=False)


def decode_bytes(arch: ArchConfig, n_params: float, B: int, cache_len: int, cache_bytes: float) -> float:
    """Decode is memory-bound: weights once + the whole cache once."""
    act = arch.n_layers * B * arch.d_model * BF16 * 12
    return n_params * BF16 + cache_bytes + act


def moe_active_params(arch: ArchConfig, n_params_matmul: float) -> float:
    if arch.moe is None:
        return n_params_matmul
    return n_params_matmul * arch.active_param_count() / arch.param_count()


def cell_cost(
    arch: ArchConfig,
    shape: ShapeConfig,
    n_params_matmul: float,
    cache_bytes: float = 0.0,
    microbatches: int = 1,
) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fwd = forward_flops(arch, B, S, compiled=True)
        fwd_total = sum(fwd.values())
        # bwd = 2x fwd, remat adds ~1x fwd recompute
        compiled = fwd_total * 4.0
        useful = 6.0 * moe_active_params(arch, n_params_matmul) * B * S + (
            3.0 * sum(forward_flops(arch, B, S, compiled=False).values())
            - 3.0 * 2 * B * S * moe_active_params(arch, n_params_matmul)
        )
        # useful = 6*N_active*D plus exact causal attention (3x fwd attention)
        useful = max(useful, 6.0 * moe_active_params(arch, n_params_matmul) * B * S)
        bytes_hbm = train_bytes(arch, n_params_matmul, B, S, microbatches)
        return CellCost(compiled, useful, bytes_hbm, fwd)
    if shape.kind == "prefill":
        fwd = forward_flops(arch, B, S, compiled=True)
        compiled = sum(fwd.values())
        useful = sum(forward_flops(arch, B, S, compiled=False).values())
        return CellCost(compiled, useful, prefill_bytes(arch, n_params_matmul, B, S), fwd)
    # decode
    fwd = decode_flops(arch, B, S)
    compiled = sum(fwd.values())
    useful = compiled  # decode computes no masked waste
    return CellCost(
        compiled, useful, decode_bytes(arch, n_params_matmul, B, S, cache_bytes), fwd
    )
