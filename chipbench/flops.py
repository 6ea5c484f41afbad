"""The work the benchmark's calls need, counted from the configuration's
shapes alone: the model operations of a prompt forward and of a training
step (the yardstick of ``mfu``), and the operations and bytes of the
attention kernel's calls (the yardstick of its roofline).

A multiply-add counts 2.  A family's model operations of one forward are
counted by its own file, ``chipbench/counts/<counts>.py``, which the
configuration names under ``counts``; it gives ``forward_flops(cfg, rows,
S, head_positions)`` and ``attention_calls(cfg)``, the causal attention
calls of one forward.  A prompt forward needs the head at the last position
of each row; a training step counts three forwards with the head at every
position, and no recompute.
"""

from __future__ import annotations

import importlib


def counts(cfg: dict):
    """The family's counting module named by the configuration."""
    return importlib.import_module(f"chipbench.counts.{cfg['counts']}")


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def score_flops(cfg: dict, rows: int, S: int) -> float:
    """A prompt forward that answers with the last position's logits."""
    return counts(cfg).forward_flops(cfg, rows, S, head_positions=1)


def train_flops(cfg: dict, rows: int, S: int) -> float:
    """A training step: three forwards, the loss over every position."""
    return 3 * counts(cfg).forward_flops(cfg, rows, S, head_positions=S)


def flash_work(B: int, S: int, H: int, K: int, hd: int, dtype_bytes: int):
    """(bytes, operations) of one causal attention call: q, k, v and the
    output once; 4 hd per head and unmasked query-key pair."""
    return dtype_bytes * B * S * hd * (2 * H + 2 * K), 4 * hd * B * H * causal_pairs(S)


def bound_s(nbytes: float, flops: float, flops_per_s: float, bytes_per_s: float) -> float:
    """The least time of a call: the larger of its bytes over the memory's
    rate and its operations over the peak where they run."""
    return max(nbytes / bytes_per_s, flops / flops_per_s)
