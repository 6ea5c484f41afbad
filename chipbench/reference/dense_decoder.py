"""Plain float32 reference of the dense decoder (granite-3-8b and its
pipeline stage), and the weights that the benchmark hands to both sides.

A pre-norm decoder: token embedding; per layer x += attention(rms(x)),
x += glu_mlp(rms(x)); a final RMS norm; the head (the embedding's
transpose when tied).  Attention is grouped-query, causal, with rotary
embedding of base ``rope_theta`` on the two halves of each head, scaled by
1/sqrt(head_dim).  The vocabulary is padded to a multiple of 256 rows
(``padded_vocab``): the pad rows are drawn like the others, are never a
token, and take part in the softmax of the loss.

The weights are made on the device from the seed, in the type the
configuration serves, one draw per stacked leaf, and laid out as the
program takes them (every layer's leaves stacked on a leading axis).  The
reference reads them layer by layer in float32.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.utils.checkpoint

from .plain import Matmul, attention_block, exact_mm, glu_mlp, rms_norm, token_ce

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(cfg: dict) -> int:
    return (cfg["vocab_size"] + 255) // 256 * 256


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


class Draws:
    """The seeded draws of one set of weights, in a fixed order."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def normal(self, shape, scale: float, dtype=None) -> torch.Tensor:
        dtype = dtype or self.dtype
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=dtype).mul_(scale)

    def near_one(self, shape) -> torch.Tensor:
        """A float32 scale of 1 + 0.1 z."""
        return self.normal(shape, 0.1, torch.float32).add_(1.0)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device).mul_(hi - lo).add_(lo)


def block_weights(draw: Draws, cfg: dict, lead=()) -> Dict[str, Dict[str, torch.Tensor]]:
    """One attention + MLP block's weights, stacked on ``lead``."""
    d, H, K, hd, ff = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg), cfg["d_ff"]
    return {
        "norm_attn": {"scale": draw.near_one((*lead, d))},
        "attn": {
            "wq": draw.normal((*lead, d, H, hd), d ** -0.5),
            "wk": draw.normal((*lead, d, K, hd), d ** -0.5),
            "wv": draw.normal((*lead, d, K, hd), d ** -0.5),
            "wo": draw.normal((*lead, H, hd, d), (H * hd) ** -0.5),
        },
        "norm_mlp": {"scale": draw.near_one((*lead, d))},
        "mlp": {
            "wi": draw.normal((*lead, d, ff), d ** -0.5),
            "wg": draw.normal((*lead, d, ff), d ** -0.5),
            "wo": draw.normal((*lead, ff, d), ff ** -0.5),
        },
    }


def init_weights(cfg: dict, seed: int, device) -> dict:
    draw = Draws(seed, device, DTYPES[cfg["param_dtype"]])
    w = {
        "embed": draw.normal((padded_vocab(cfg), cfg["d_model"]), 0.02),
        "layers": block_weights(draw, cfg, lead=(cfg["n_layers"],)),
        "final_norm": {"scale": draw.near_one((cfg["d_model"],))},
    }
    if not cfg.get("tied_embeddings"):
        w["lm_head"] = draw.normal((cfg["d_model"], padded_vocab(cfg)), 0.02)
    return w


def take(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    return tree[i]


def index(tree, i: int):
    """Layer ``i`` of a stacked tree, as a float32 copy."""
    if isinstance(tree, dict):
        return {k: index(v, i) for k, v in tree.items()}
    return tree[i].to(torch.float32, copy=True)


def f32_tree(tree):
    """A float32 copy of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32_tree(v) for v in tree]
    return tree.to(torch.float32, copy=True)


def head(w: dict) -> torch.Tensor:
    """The (d, V_padded) head in float32."""
    return w["lm_head"].float() if "lm_head" in w else w["embed"].float().t()


def block(bw: dict, x: torch.Tensor, cfg: dict, mm: Matmul) -> torch.Tensor:
    """One pre-norm block on rows x (R, S, d)."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, bw["norm_attn"]["scale"], eps)
    x = x + torch.stack([attention_block(bw["attn"], r, theta, mm) for r in h])
    h = rms_norm(x, bw["norm_mlp"]["scale"], eps)
    return x + glu_mlp(bw["mlp"], h, cfg["mlp_act"], mm)


@torch.no_grad()
def last_logits(w: dict, cfg: dict, tokens: torch.Tensor, mm: Matmul = exact_mm) -> torch.Tensor:
    """Float32 logits over the vocabulary (not its padding) at the last
    position of each row of tokens (R, S)."""
    x = w["embed"][tokens].float()
    for i in range(cfg["n_layers"]):
        x = block(index(w["layers"], i), x, cfg, mm)
    h = rms_norm(x[:, -1], w["final_norm"]["scale"].float(), cfg["rms_norm_eps"])
    return mm(h, head(w))[:, : cfg["vocab_size"]]


def split_layers(w: dict) -> dict:
    """The weights with the stacked layers as a list of per-layer trees
    (views)."""
    n = w["layers"]["attn"]["wq"].shape[0]
    return {**{k: v for k, v in w.items() if k != "layers"}, "layers": [take(w["layers"], i) for i in range(n)]}


def master(w: dict) -> dict:
    """A float32 copy of the weights that autograd trains, the layers as a
    list (``split_layers``)."""
    out = f32_tree(split_layers(w))
    for leaf in leaves(out):
        leaf.requires_grad_(True)
    return out


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def loss_sum(mw: dict, cfg: dict, tokens: torch.Tensor, mm: Matmul = exact_mm) -> torch.Tensor:
    """Summed next-token cross-entropy of rows tokens (R, S) under the
    master weights ``mw``; each layer recomputed in the backward pass."""
    x = mw["embed"][tokens]
    for bw in mw["layers"]:
        x = torch.utils.checkpoint.checkpoint(
            lambda x_, bw_: block(bw_, x_, cfg, mm), x, bw, use_reentrant=False)
    h = rms_norm(x[:, :-1], mw["final_norm"]["scale"], cfg["rms_norm_eps"])
    hd = mw["lm_head"] if "lm_head" in mw else mw["embed"].t()
    return sum(token_ce(mm(r, hd), t) for r, t in zip(h, tokens[:, 1:]))
