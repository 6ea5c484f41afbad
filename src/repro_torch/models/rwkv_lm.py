"""RWKV6 language model assembly, the attention-free family (counterpart of
``repro.models.rwkv_lm``).

Parameters keep the JAX layout (blocks stacked on a leading layer axis).
The decode cache is O(1) in the sequence length: per layer a (B, H, P, P)
WKV state and the two token-shift carries.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .layers import apply_norm, embed_init, init_norm
from .rwkv import apply_rwkv_block, init_rwkv_block
from .transformer import (
    _torch_dtype,
    embed_inputs,
    layer_params,
    logits_from_hidden,
    on_layer,
    remat_body,
    residual,
    unstack,
)

PyTree = Any


def init_params(gen: torch.Generator, cfg: ArchConfig, device) -> PyTree:
    dtype = _torch_dtype(cfg.param_dtype)
    p = {
        "embed": embed_init(gen, (cfg.padded_vocab_size, cfg.d_model), dtype, device),
        "embed_norm": init_norm(cfg, device),  # RWKV normalises the embedding
        "layers": init_rwkv_block(gen, cfg, dtype, device, lead=(cfg.n_layers,)),
        "final_norm": init_norm(cfg, device),
    }
    if not cfg.tied_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab_size), dtype, device)
    return p


def _layer(layer_p: PyTree, x: torch.Tensor, cfg: ArchConfig, impl: str) -> torch.Tensor:
    """One RWKV6 block from a zero state."""
    return apply_rwkv_block(layer_p, x, cfg, None, impl=impl)[0]


def forward(
    p: PyTree,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    impl: str = "torch",
    remat: str = "block",
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill forward pass: every layer starts from a zero
    state (the whole sequence is processed at once).  ``remat="block"``
    recomputes each block in the backward pass, as JAX checkpoints its scan
    body.  Returns (logits, aux), or the final-normed hidden states with
    ``return_hidden``."""
    x = apply_norm(p["embed_norm"], embed_inputs(p, cfg, batch), cfg)
    body = remat_body(_layer, remat)
    for layer_p in unstack(p["layers"]):
        x = body(*on_layer(layer_p, x), cfg, impl)
    x = apply_norm(p["final_norm"], residual(x), cfg)
    if return_hidden:
        return x, {}
    return logits_from_hidden(p, cfg, x), {}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> PyTree:
    del max_len  # O(1) state: the point of the architecture
    d = cfg.d_model
    P = cfg.rwkv.head_dim
    H = d // P
    dtype = _torch_dtype(cfg.activation_dtype)
    L = cfg.n_layers
    return {
        "wkv": torch.zeros((L, batch, H, P, P), dtype=torch.float32, device=device),
        "shift_t": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((L, batch, d), dtype=dtype, device=device),
    }


def decode_step(
    p: PyTree,
    cfg: ArchConfig,
    cache: PyTree,
    batch: Dict[str, torch.Tensor],  # tokens: (B, 1)
    position: int,
) -> Tuple[torch.Tensor, PyTree]:
    """One token of decoding; the recurrent state carries all positional
    information.  The cache is updated in place and returned (JAX returns a
    new one)."""
    del position
    x = apply_norm(p["embed_norm"], embed_inputs(p, cfg, batch), cfg)
    for i in range(cfg.n_layers):
        state = {name: cache[name][i] for name in ("wkv", "shift_t", "shift_c")}
        x, new = apply_rwkv_block(layer_params(p["layers"], i), x, cfg, state)
        for name, value in new.items():
            cache[name][i] = value
    x = apply_norm(p["final_norm"], x, cfg)
    return logits_from_hidden(p, cfg, x), cache
