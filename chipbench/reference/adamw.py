"""Plain float32 reference of the training step: the mean next-token loss
over every row, its gradient, global-norm clipping and AdamW.

    g = grad of the mean loss;  g *= min(1, clip / |g|)   (|g| over all leaves)
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= lr_t (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

with weight decay on the weight matrices and the embedding, not on the norm
scales, and lr_t a linear warm-up over ``warmup_steps`` and then a cosine
from lr to ``min_lr_ratio`` lr at ``total_steps``.  The gradient is summed
row by row in float32 (the mean over rows of equal length is the mean of
their sums over the count of targets).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from .plain import Matmul, exact_mm


def lr_at(opt: dict, t: int) -> float:
    warm = min(t / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((t - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    floor = opt["min_lr_ratio"]
    return opt["lr"] * warm * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


class Trainer:
    """The reference's state: float32 master leaves (each requires grad), a
    name for each, and the two moments."""

    def __init__(self, named: Dict[str, torch.Tensor], decayed: Callable[[str], bool], opt: dict):
        self.named, self.decayed, self.opt = named, decayed, opt
        self.m = {k: torch.zeros_like(p) for k, p in named.items()}
        self.v = {k: torch.zeros_like(p) for k, p in named.items()}
        self.t = 0

    def step(self, loss_sum: Callable[[torch.Tensor, Matmul], torch.Tensor], tokens: torch.Tensor,
             mm: Matmul = exact_mm, rows_at_once: int = 1) -> Dict[str, object]:
        """One step on tokens (R, S); ``loss_sum(rows, mm)`` is the summed
        loss of some rows.  Returns the mean loss and each leaf's clipped
        gradient as the moments took it."""
        count = tokens.shape[0] * (tokens.shape[1] - 1)
        for p in self.named.values():
            p.grad = None
        total = 0.0
        for lo in range(0, tokens.shape[0], rows_at_once):
            loss = loss_sum(tokens[lo : lo + rows_at_once], mm) / count
            loss.backward()
            total += float(loss.detach())
        grads = {k: p.grad for k, p in self.named.items()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(self.opt["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
        self.t += 1
        o, t = self.opt, self.t
        lr = lr_at(o, t)
        b1, b2 = o["beta1"], o["beta2"]
        with torch.no_grad():
            for k, p in self.named.items():
                g = grads[k] * scale
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (self.m[k] / (1 - b1 ** t)) / (torch.sqrt(self.v[k] / (1 - b2 ** t)) + o["eps"])
                if o["weight_decay"] and self.decayed(k):
                    delta = delta + o["weight_decay"] * p
                p.sub_(lr * delta)
                grads[k] = g
        return {"loss": total, "grads": grads}


def named_leaves(tree, prefix: str = "") -> List[tuple]:
    """(name, leaf) of a tree of dicts and lists, names joined by '/'."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in named_leaves(t, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]
