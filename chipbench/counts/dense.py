"""Model operations of a dense decoder's forward: 2 per multiply-add of
every weight matrix with each token (the embedding lookup multiplies
nothing), 4 hd per head and unmasked query-key pair of causal attention,
and the head at ``head_positions`` positions of each row.  Norms,
activations and the softmax are not counted."""

from __future__ import annotations

from chipbench.flops import causal_pairs, head_dim


def attention_calls(cfg: dict) -> int:
    """Causal attention calls of one forward: one a layer."""
    return cfg["n_layers"]


def forward_flops(cfg: dict, rows: int, S: int, head_positions: int) -> float:
    d, H, K, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    attention = d * hd * (2 * H + 2 * K)  # q, k, v and the output
    mlp = (3 if cfg["mlp_act"].endswith("_glu") else 2) * d * cfg["d_ff"]
    L = cfg["n_layers"]
    return (2 * L * (attention + mlp) * rows * S + L * 4 * hd * H * causal_pairs(S) * rows
            + 2 * d * cfg["vocab_size"] * head_positions * rows)
