"""AdamW with a warm-up + cosine schedule and global-norm clipping
(counterpart of ``repro.optim.adamw``).

Plain functions over the nested-dict parameter tree, in the JAX package's
functional style: ``init`` makes the state, ``update`` takes gradients and
returns (params, state, metrics).  Moments are float32 whatever the
parameter dtype, and the update is computed in float32 and cast back to the
parameter dtype, as in JAX (``torch.optim.AdamW`` keeps its moments in the
parameter dtype, bf16 here, so it is not used).

Unlike JAX, ``update`` writes the parameters and both moments in place and
returns the same tensors: at full width one float32 temporary of a stacked
leaf is gigabytes (zamba2-2.7b's ``in_proj`` has 1.44 B elements), so the
elementwise update runs over flat spans of at most ``SPAN`` elements of each
leaf, which gives the same numbers with temporaries of one span.

DTensor leaves (the dry-run) are updated on their local shards, which must
have the same placements for a parameter, its gradient and its moments;
the global norm sums each shard's squares and all-reduces them over the
mesh dimensions that shard the leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree

PyTree = Any

# Elements per span of the in-place update and of global_norm's squares:
# each float32 temporary of a span is 128 MiB.
SPAN = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: Optional[float] = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: PyTree  # float32, like params
    v: PyTree  # float32, like params


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or an integer tensor): linear
    warm-up, then cosine to ``min_lr_ratio``, in float32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    floor = cfg.min_lr_ratio
    return cfg.lr * warm * (floor + (1 - floor) * cos)


def init(params: PyTree) -> AdamWState:
    first = tree.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree.tree_map(zeros, params),
        v=tree.tree_map(zeros, params),
    )


def _spans(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Flat spans of ``t`` of at most ``SPAN`` elements: views where ``t``
    is contiguous (as ``update`` checks of what it writes), else copies."""
    flat = t.reshape(-1)
    for start in range(0, flat.numel(), SPAN):
        yield flat[start : start + SPAN]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage), or ``t``."""
    return t.to_local() if hasattr(t, "placements") else t


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of ``g``, span by span; for a DTensor,
    the local shard's, all-reduced over the mesh dimensions sharding it."""
    total = None
    for span in _spans(_local(g)):
        sq = torch.sum(torch.square(span.float()))
        total = sq if total is None else total + sq
    if hasattr(g, "placements"):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        partial = [Partial() if isinstance(pl, Shard) else Replicate() for pl in g.placements]
        total = DTensor.from_local(total, g.device_mesh, partial, run_check=False)
        total = total.redistribute(g.device_mesh, [Replicate()] * len(partial)).to_local()
    return total


def global_norm(grads: PyTree) -> torch.Tensor:
    """sqrt of the sum of float32 squares over every leaf."""
    total = None
    for g in tree.leaves(grads):
        sq = _sum_squares(g)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def decayed(path, p: torch.Tensor) -> bool:
    """Whether weight decay applies to the leaf at ``path``: not to norm
    scales or biases (by the last key's name, as ``_decay_mask``), nor to
    leaves below 2-D counted with the stacked layer axis."""
    last = str(path[-1]) if path else ""
    return "scale" not in last and "bias" not in last and p.dim() >= 2


def update(
    cfg: AdamWConfig, grads: PyTree, state: AdamWState, params: PyTree
) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``params``, ``state.m`` and ``state.v`` are updated
    in place and returned; ``grads`` is only read."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    f32 = dict(dtype=torch.float32, device=step.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), step.float())
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), step.float())

    named = tree.leaves_with_path(params)
    for (path, p), g, m, v in zip(named, tree.leaves(grads), tree.leaves(state.m),
                                  tree.leaves(state.v), strict=True):
        if g.shape != p.shape:
            raise ValueError(f"{path}: gradient shape {tuple(g.shape)} != parameter {tuple(p.shape)}")
        if hasattr(p, "placements"):
            if not all(getattr(t, "placements", None) == p.placements for t in (g, m, v)):
                raise ValueError(f"{path}: a DTensor update needs one placement for the "
                                 "parameter, its gradient and its moments")
            p, g, m, v = (_local(t) for t in (p, g, m, v))
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"{path}: the in-place update needs contiguous parameters and moments")
        decay = bool(cfg.weight_decay) and decayed(path, p)
        for ps, gs, ms, vs in zip(_spans(p), _spans(g), _spans(m), _spans(v)):
            gf = gs.float() if scale is None else gs.float() * scale
            ms.mul_(b1).add_(gf, alpha=1 - b1)
            vs.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            delta = (ms / bc1).div_(torch.sqrt(vs / bc2).add_(cfg.eps))
            pf = ps.float()
            if decay:
                delta.add_(pf, alpha=cfg.weight_decay)
            ps.copy_(pf.sub_(delta.mul_(lr)))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), metrics
