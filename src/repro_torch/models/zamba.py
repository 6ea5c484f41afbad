"""Zamba2-style hybrid: a Mamba2 backbone with a *shared* attention block
(counterpart of ``repro.models.zamba``).

Layer layout: groups of ``shared_attn_every`` Mamba2 layers, each group
followed by one application of a single shared transformer block (attention
+ MLP, the same weights every application).  As in the JAX package, the
shared block reads the hidden stream (the public model feeds it the
concatenated [hidden, initial-embedding] stream).

Parameters keep the JAX layout: the Mamba2 layers' leaves are stacked on
leading (groups, layers-per-group) axes, so a JAX tree converts leaf for
leaf.  Where JAX scans over those axes, the port loops in Python over
per-layer views.  ``remat="block"`` recomputes each Mamba2 layer in the
backward pass, as JAX checkpoints its Mamba2 scan body (the shared block is
not rematerialised there either).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .layers import apply_norm, embed_init, init_norm
from .mamba2 import apply_mamba2, init_mamba2, ssm_dims
from .transformer import (
    _torch_dtype,
    apply_block,
    apply_block_decode,
    embed_inputs,
    init_block,
    layer_params,
    logits_from_hidden,
    on_layer,
    remat_body,
    residual,
    unstack,
)

PyTree = Any


def n_groups(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.name}: n_layers must be a multiple of shared_attn_every")
    return cfg.n_layers // cfg.shared_attn_every


def init_params(gen: torch.Generator, cfg: ArchConfig, device) -> PyTree:
    """Random parameters drawn on ``device`` from ``gen``; the Mamba2 layers
    are stacked on (G, L) axes, as the JAX package reshapes them."""
    dtype = _torch_dtype(cfg.param_dtype)
    lead = (n_groups(cfg), cfg.shared_attn_every)
    p = {
        "embed": embed_init(gen, (cfg.padded_vocab_size, cfg.d_model), dtype, device),
        "mamba_layers": {
            "norm": init_norm(cfg, device, lead=lead),
            "mamba": init_mamba2(gen, cfg, dtype, device, lead=lead),
        },
        "shared_attn": init_block(gen, cfg, device),
        "final_norm": init_norm(cfg, device),
    }
    if not cfg.tied_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab_size), dtype, device)
    return p


def _mamba_layer(layer_p: PyTree, x: torch.Tensor, cfg: ArchConfig, impl: str) -> torch.Tensor:
    """One pre-normed residual Mamba2 layer from a zero state."""
    out, _ = apply_mamba2(layer_p["mamba"], apply_norm(layer_p["norm"], x, cfg), cfg, None, impl)
    return x + out


def forward(
    p: PyTree,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    impl: str = "torch",
    remat: str = "block",
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill forward pass: every Mamba2 layer starts from a
    zero state (the whole sequence is processed at once).  Returns (logits,
    aux), or the final-normed hidden states with ``return_hidden``."""
    x = embed_inputs(p, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    body = remat_body(_mamba_layer, remat)
    layers = unstack(p["mamba_layers"], lead=2)  # (group, layer) flattened
    L = cfg.shared_attn_every
    for g in range(n_groups(cfg)):
        for layer_p in layers[g * L : (g + 1) * L]:
            x = body(*on_layer(layer_p, x), cfg, impl)
        x, _ = apply_block(p["shared_attn"], x, cfg, positions, impl)
    x = apply_norm(p["final_norm"], residual(x), cfg)
    if return_hidden:
        return x, {}
    return logits_from_hidden(p, cfg, x), {}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> PyTree:
    G, L = n_groups(cfg), cfg.shared_attn_every
    s = cfg.ssm
    d_in, H, P, N = ssm_dims(cfg)
    dtype = _torch_dtype(cfg.activation_dtype)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((G, L, batch, s.conv_width - 1, d_in + 2 * s.n_groups * N), **f32),
        "ssm": torch.zeros((G, L, batch, H, N, P), **f32),
        # one KV cache per shared-attention application
        "k": torch.zeros((G, batch, max_len, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((G, batch, max_len, K, hd), dtype=dtype, device=device),
    }


def decode_step(
    p: PyTree,
    cfg: ArchConfig,
    cache: PyTree,
    batch: Dict[str, torch.Tensor],  # tokens: (B, 1)
    position: int,
) -> Tuple[torch.Tensor, PyTree]:
    """One token of decoding.  The cache is updated in place and returned
    (JAX returns a new one), as the dense ``decode_step`` does.  The conv
    state is stored in float32 (``init_cache``'s type) and holds values of
    the activation type, which float32 keeps exactly."""
    x = embed_inputs(p, cfg, batch)
    for g in range(n_groups(cfg)):
        group_p = layer_params(p["mamba_layers"], g)
        for i in range(cfg.shared_attn_every):
            layer_p = layer_params(group_p, i)
            state = {"conv": cache["conv"][g, i], "ssm": cache["ssm"][g, i]}
            out, new = apply_mamba2(
                layer_p["mamba"], apply_norm(layer_p["norm"], x, cfg), cfg, state
            )
            cache["conv"][g, i] = new["conv"]
            cache["ssm"][g, i] = new["ssm"]
            x = x + out
        layer_cache = {"k": cache["k"][g], "v": cache["v"][g]}
        x = apply_block_decode(p["shared_attn"], x, cfg, layer_cache, position, position)
    x = apply_norm(p["final_norm"], x, cfg)
    return logits_from_hidden(p, cfg, x), cache
