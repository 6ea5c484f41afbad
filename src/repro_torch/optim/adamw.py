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

DTensor leaves (the dry-run) are updated on their local shards; the global
norm sums each shard's squares and all-reduces them over the mesh
dimensions that shard the leaf.  A parameter and its gradient share
placements, and so do its moments.  Where they differ, the moments must
shard what the parameter replicates (ZeRO-1: the parameter replicated over
the fsdp axes, its moments sharded there), and the update does what XLA
does for JAX's ZeRO-1: it takes the gradient and the parameter at the
moments' shard by a local slice, with no collective, updates that piece
and the moment shards, and all-gathers the pieces into the replicated
parameter (one all-gather per parameter per step).
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


def _local_box(t) -> Tuple[Tuple[int, int], ...]:
    """(offset, size) in each dimension of the DTensor ``t``'s local shard
    within the global tensor."""
    from repro_torch.models.layers import shard_index

    return tuple((index * size, size) for index, size in (shard_index(t, d) for d in range(t.dim())))


def _zero1_slices(p, m, path) -> Tuple[slice, ...]:
    """The slices of ``p``'s local shard that ``m``'s local shard covers,
    where ``m`` shards over mesh dimensions that replicate ``p``."""
    for pl_p, pl_m in zip(p.placements, m.placements):
        if pl_p != pl_m and not (pl_p.is_replicate() and pl_m.is_shard()):
            raise ValueError(f"{path}: the moments' placements {m.placements} do not shard what the "
                             f"parameter's {p.placements} replicate")
    out = []
    for (p_off, p_size), (m_off, m_size) in zip(_local_box(p), _local_box(m)):
        if not p_off <= m_off <= m_off + m_size <= p_off + p_size:
            raise ValueError(f"{path}: the moments' shard is not within the parameter's local shard")
        out.append(slice(m_off - p_off, m_off - p_off + m_size))
    return tuple(out)


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
    in place and returned; ``grads`` is only read.  DTensor leaves are
    updated on their local shards, a ZeRO-1 parameter on the piece its
    moments' shards cover, then all-gathered (see the module's note)."""
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
        gathered = None  # a ZeRO-1 parameter: (the DTensor, the piece of it updated here)
        if hasattr(p, "placements"):
            if getattr(g, "placements", None) != p.placements or getattr(v, "placements", None) != m.placements:
                raise ValueError(f"{path}: a DTensor update needs the gradient placed as the "
                                 "parameter and the two moments placed alike")
            if m.placements == p.placements:
                p, g, m, v = (_local(t) for t in (p, g, m, v))
            else:
                cut = _zero1_slices(p, m, path)
                gathered = (p, _local(p)[cut].contiguous(), m.placements)
                p, g, m, v = gathered[1], _local(g)[cut], _local(m), _local(v)
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
        if gathered is not None:
            from torch.distributed.tensor import DTensor

            whole, piece, pieces = gathered
            new = DTensor.from_local(piece, whole.device_mesh, pieces, run_check=False,
                                     shape=whole.shape, stride=whole.stride())
            _local(whole).copy_(new.redistribute(whole.device_mesh, whole.placements).to_local())
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), metrics
