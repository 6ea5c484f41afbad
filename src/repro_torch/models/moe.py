"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch
(counterpart of ``repro.models.moe``).

The same routing as the JAX layer, step for step:
  * router logits in float32, softmax, top-k (a stable descending sort, so
    the lower expert id wins a tie, as ``lax.top_k``), Mixtral's
    renormalisation of the k weights, and the switch auxiliary loss over
    the top-1 assignments;
  * per batch row, the (token, slot) pairs are stably sorted by expert id;
    each expert takes its first C = ceil(T * k / E * capacity_factor)
    pairs, the rest go to an overflow slot and are dropped (their combine
    weight is zero);
  * the experts' FFNs run as one batched product over the (E, B * C, d)
    buckets; the combine is a scatter-add with the weights cast to the
    activation dtype, as JAX's ``.at[].add``.

The JAX layer reaches no Pallas kernel (it is einsums, a sort and
scatters), so the port is PyTorch ops with ``torch.matmul`` for the expert
products.  Dispatch and combine index flat (rows, d) views, so no index
tensor of the activations' size is built.

``routing(hook)`` lets a caller see and replace each layer's top-k inside
its ``with`` block (the serve check uses it: ``launch/serve.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, torch.Tensor]


def expert_capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    moe = cfg.moe
    c = math.ceil(tokens_per_group * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(4, (c + 3) // 4 * 4)  # pad to a multiple of 4


def _slab_init(gen: torch.Generator, in_dim: int, shape, dtype, device) -> torch.Tensor:
    """``layers.dense_init`` drawn one matrix (the last two axes) at a time
    into a preallocated leaf: the float32 draw of a stacked expert leaf
    whole would be twice the bf16 leaf (30 GB for mixtral's ``wi`` at 16
    layers)."""
    scale = 1.0 / math.sqrt(in_dim)
    out = torch.empty(shape, dtype=dtype, device=device)
    for slab in out.view(-1, *shape[-2:]):
        x = torch.randn(shape[-2:], generator=gen, dtype=torch.float32, device=device)
        slab.copy_(x * scale)
    return out


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, device, lead=()) -> Params:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {
        "router": _slab_init(gen, d, (*lead, d, E), torch.float32, device),
        "wi": _slab_init(gen, d, (*lead, E, d, ff), dtype, device),
        "wo": _slab_init(gen, ff, (*lead, E, ff, d), dtype, device),
    }
    if cfg.mlp_act.endswith("_glu"):
        p["wg"] = _slab_init(gen, d, (*lead, E, d, ff), dtype, device)
    return p


def _expert_ffn(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d), batched over experts."""
    h = torch.matmul(x, p["wi"])
    if cfg.mlp_act == "silu_glu":
        h = F.silu(h) * torch.matmul(x, p["wg"])
    elif cfg.mlp_act == "gelu_glu":
        h = F.gelu(h, approximate="tanh") * torch.matmul(x, p["wg"])  # jax.nn.gelu default
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, p["wo"])


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis and their indices, ties to the
    lower index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


RoutingHook = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# The hook of the enclosing ``routing`` block in this thread or task, if any.
_routing_hook: contextvars.ContextVar = contextvars.ContextVar("moe_routing_hook", default=None)


@contextlib.contextmanager
def routing(hook: RoutingHook) -> Iterator[RoutingHook]:
    """Inside the block, in this thread or task only, every ``apply_moe``
    calls ``hook(probs, top_w, top_ids)`` with its router probabilities
    (B, S, E) and its own top-k (B, S, k), and routes by the (weights, ids)
    it returns.  One hook at a time: a nested ``routing`` raises.  For
    inference: a remat recompute in the backward runs on autograd's threads,
    which do not see the hook."""
    if _routing_hook.get() is not None:
        raise RuntimeError("an MoE routing hook is already set")
    token = _routing_hook.set(hook)
    try:
        yield hook
    finally:
        _routing_hook.reset(token)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k that ``apply_moe`` routes by: its own, or what the hook of
    an enclosing ``routing`` block makes of it."""
    top_w, top_ids = top_k(probs, k)
    hook = _routing_hook.get()
    return (top_w, top_ids) if hook is None else hook(probs, top_w, top_ids)


def apply_moe(p: Params, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), aux metrics (load-balance loss, drop rate)."""
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.num_experts, moe.top_k
    C = expert_capacity(cfg, S)
    dev = x.device

    logits = x.float() @ p["router"]  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = route(probs, k)  # (B, S, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)  # Mixtral renorm

    # Switch aux loss: E * sum_e (fraction of tokens to e) * (mean prob of e)
    frac = F.one_hot(top_ids[..., 0], E).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux_loss = E * torch.sum(frac * mean_prob)

    if hasattr(x, "placements"):  # DTensors (the dry-run)
        eb, slot, tok_s, wk, keep = _on_batch_shards(
            lambda *t: _dispatch(*t, E, C), x, (x, top_w, top_ids), (0, 0, 0), (1, 0, 0, 0, 0)
        )
        eo = _expert_ffn(p, eb, cfg)
        y = _on_batch_shards(lambda *t: _combine(*t, E, C, S), x, (eo, slot, tok_s, wk), (1, 0, 0, 0), (0,))[0]
    else:
        eb, slot, tok_s, wk, keep = _dispatch(x, top_w, top_ids, E, C)
        y = _combine(_expert_ffn(p, eb, cfg), slot, tok_s, wk, E, C, S)
    drop_rate = 1.0 - keep.float().mean(dim=-1).mean()
    return y, {"moe_aux_loss": aux_loss, "moe_drop_rate": drop_rate}


def _dispatch(x: torch.Tensor, top_w: torch.Tensor, top_ids: torch.Tensor, E: int, C: int):
    """Per batch row, the (token, slot) pairs stably sorted by expert, each
    expert's first C kept: the (E, B * C, d) expert buckets, and each
    sorted pair's slot (the overflow slot E * C when dropped), token,
    combine weight (zero when dropped) and keep flag, all (B, S * k)."""
    B, S, d = x.shape
    k = top_ids.shape[-1]
    dev = x.device
    ids = top_ids.reshape(B, S * k)
    ids_s, order = torch.sort(ids, dim=-1, stable=True)
    tok_s = torch.div(order, k, rounding_mode="floor")  # jnp.repeat(arange(S), k)[order]
    w_s = torch.gather(top_w.reshape(B, S * k), 1, order)
    # rank of each entry within its expert: each expert's first index in
    # the sorted ids is the exclusive cumulative sum of the per-expert
    # counts (``searchsorted(side="left")``, integer-exact)
    counts = torch.zeros(B, E, dtype=ids.dtype, device=dev).scatter_add_(1, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(S * k, device=dev) - torch.gather(starts, 1, ids_s)
    keep = rank < C
    slot = torch.where(keep, ids_s * C + rank, E * C)  # dropped -> overflow slot
    rows = E * C + 1
    flat_slot = (slot + torch.arange(B, device=dev)[:, None] * rows).reshape(-1)
    flat_tok = (tok_s + torch.arange(B, device=dev)[:, None] * S).reshape(-1)
    src = x.reshape(B * S, d)[flat_tok] * keep.reshape(-1, 1).to(x.dtype)
    bucket = torch.zeros(B * rows, d, dtype=x.dtype, device=dev).index_add_(0, flat_slot, src)
    # (B, E, C, d) -> merge groups into the capacity dim: (E, B*C, d)
    eb = bucket.view(B, rows, d)[:, :-1].reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    return eb, slot, tok_s, w_s * keep, keep


def _combine(eo: torch.Tensor, slot: torch.Tensor, tok_s: torch.Tensor, wk: torch.Tensor,
             E: int, C: int, S: int) -> torch.Tensor:
    """Each pair's expert output, weighted, added into its token: (B, S, d)
    from the (E, B * C, d) expert outputs and :func:`_dispatch`'s pairs."""
    B = slot.shape[0]
    d = eo.shape[-1]
    dev = eo.device
    rows = E * C + 1
    ob = eo.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    obf = torch.cat([ob, torch.zeros(B, 1, d, dtype=ob.dtype, device=dev)], dim=1)
    flat_slot = (slot + torch.arange(B, device=dev)[:, None] * rows).reshape(-1)
    flat_tok = (tok_s + torch.arange(B, device=dev)[:, None] * S).reshape(-1)
    vals = obf.reshape(B * rows, d)[flat_slot] * wk.reshape(-1, 1).to(ob.dtype)
    y = torch.zeros(B * S, d, dtype=ob.dtype, device=dev).index_add_(0, flat_tok, vals)
    return y.view(B, S, d)


def _on_batch_shards(fn, x: torch.Tensor, args, in_dims, out_dims):
    """``fn`` on DTensor ``args``, run on each rank's batch shards: the
    dispatch and the combine are independent across batch rows.  Each
    ``args[i]`` has its batch dimension ``in_dims[i]`` sharded over the mesh
    dimensions that shard the layer input ``x``'s batch and is replicated
    over the others; output ``j`` is laid out alike with its batch
    dimension ``out_dims[j]`` (the buckets' (E, B * C, d) hold each batch
    row's C slots contiguously, so a batch shard is a shard of their
    dimension 1)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    batch = [isinstance(pl, Shard) and pl.dim == 0 for pl in x.placements]

    def layout(dim):
        return [Shard(dim) if b else Replicate() for b in batch]

    args = tuple(a.redistribute(mesh, layout(dim)) for a, dim in zip(args, in_dims))
    run = local_map(fn, out_placements=tuple(layout(dim) for dim in out_dims),
                    in_placements=tuple(layout(dim) for dim in in_dims), device_mesh=mesh)
    out = run(*args)
    return out if isinstance(out, tuple) else (out,)
