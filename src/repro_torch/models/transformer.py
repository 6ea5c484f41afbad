"""Decoder-only transformer LM assembly: the dense, MoE, audio and VLM
families (counterpart of ``repro.models.transformer``).

Parameters keep the JAX layout: every block's leaves are stacked on a
leading layer axis, so a JAX parameter tree converts leaf for leaf
(``repro_torch.interop``).  Where JAX scans over that axis, the port loops
over it in Python over per-layer views (``unstack``; ``layer_params`` in
decode).  MoE blocks (``models/moe.py``) replace the MLP per config; the
forward returns their auxiliary metrics averaged over layers, and decode
discards them, as JAX does.  The modality frontends are the JAX package's
stubs: audio configs take precomputed frame embeddings (B, S, d) in place
of tokens and predict every codebook from one head each; VLM configs
prepend precomputed patch embeddings (B, P, d) on a full forward, and
decode takes tokens only.

``remat="block"`` recomputes each layer body in the backward pass, as JAX's
``jax.checkpoint`` around the scan body does, and ``remat="dots"`` saves
the weight products' outputs and recomputes the rest, as JAX's
``checkpoint_dots_with_no_batch_dims`` policy does; both act only while
autograd records, so a forward under ``inference_mode`` (serving) is
untouched.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from . import moe as moe_lib
from .layers import (
    apply_mlp,
    apply_norm,
    embed_init,
    init_attention,
    init_mlp,
    init_norm,
    lookup,
    run_attention,
    run_attention_decode,
)

PyTree = Any


def _torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def layer_params(layers: PyTree, i: int) -> PyTree:
    """Layer ``i``'s parameters: each stacked leaf indexed on its first axis."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def unstack(layers: PyTree, lead: int = 1) -> List[PyTree]:
    """Every layer's parameters, as views: one ``unbind`` per stacked leaf
    over its first ``lead`` axes taken as one.  Under autograd the backward
    of each leaf is then one ``stack``, where indexing layer by layer
    (``layer_params``) zero-fills a tensor of the whole leaf for every
    layer."""
    if isinstance(layers, dict):
        per_key = {k: unstack(v, lead) for k, v in layers.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(layers.flatten(0, lead - 1).unbind(0))


def on_layer(layer_p: PyTree, x: torch.Tensor) -> Tuple[PyTree, torch.Tensor]:
    """One layer's parameters and input as the layer takes them.  For
    DTensors (the dry-run) while autograd records, each is passed through
    an identity whose backward lays out its gradient as soon as the
    layer's backward has made it: a parameter's reduced to the parameter's
    shards (ZeRO-3's reduce-scatter, layer by layer: no rank holds the
    partial gradient of the whole stack), the input's as
    :func:`residual` lays it out."""
    if not (hasattr(x, "placements") and torch.is_grad_enabled()):
        return layer_p, x
    return tree.tree_map(lambda t: _grad_as(t, t.placements), layer_p), residual(x)


def residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream ``x``; for a DTensor (the dry-run) while autograd
    records, its gradient batch-sharded and replicated over "model", as
    GSPMD keeps the residual stream.  Left to itself, DTensor
    reduce-scatters the final norm's gradient over the sequence, and every
    weight gradient below it is then computed whole on each rank (62 GB on
    nemotron-4-340b's train cell)."""
    if not (hasattr(x, "placements") and torch.is_grad_enabled()):
        return x
    from torch.distributed.tensor import Replicate

    return _grad_as(x, [Replicate() if pl.is_partial() else pl for pl in x.placements])


def _grad_as(t: torch.Tensor, placements) -> torch.Tensor:
    return _GradAs.apply(t, tuple(placements)) if t.requires_grad else t


class _GradAs(torch.autograd.Function):
    """The identity on a DTensor whose backward redistributes the gradient
    to ``placements``.  The node is made where the layer starts, so the
    engine runs it right after the layer's backward (a hook on a tensor
    made earlier, as ``unstack``'s views are, would run only once every
    layer's gradient is in)."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def _save_dots(ctx, op, *args, **kwargs):
    """The policy of ``remat="dots"``, JAX's
    ``checkpoint_dots_with_no_batch_dims``: keep the outputs of products
    with no batch dimension (the weight products, which reach ``mm``,
    ``addmm`` or a ``bmm`` of batch 1, as musicgen's codebook-head einsum
    does) and recompute everything else (attention scores, expert-batched
    products, elementwise work)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_body(body: Callable, remat: str) -> Callable:
    """``body(layer_p, x, *rest)`` under a remat policy, while autograd
    records: ``"block"`` wraps it in non-reentrant
    ``torch.utils.checkpoint`` (its activations are recomputed in the
    backward pass; an input replicated over a "model" mesh dimension, the
    dry-run's residual stream, is kept as :class:`_SequenceSlice` keeps
    it), ``"dots"`` checkpoints it selectively, saving the weight
    products' outputs (:func:`_save_dots`), and ``"none"`` keeps every
    activation."""
    if remat not in ("block", "dots", "none"):
        raise ValueError(f"unknown remat policy {remat!r} (block | dots | none)")
    if remat == "none" or not torch.is_grad_enabled():
        return body
    if remat == "dots":
        context_fn = functools.partial(torch.utils.checkpoint.create_selective_checkpoint_contexts, _save_dots)
        return lambda *args: torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False, context_fn=context_fn)

    def block(layer_p, x, *rest):
        if _model_dim(x) is None:
            return torch.utils.checkpoint.checkpoint(body, layer_p, x, *rest, use_reentrant=False)
        held = _SequenceSlice(x)
        out = torch.utils.checkpoint.checkpoint(
            lambda p, h, *r: body(p, h.get(), *r), layer_p, held, *rest, use_reentrant=False)
        held.cut()
        return out

    return block


def _model_dim(x: torch.Tensor):
    """The mesh dimension named "model" over which the DTensor ``x`` is
    replicated, when it has more than one rank; else None."""
    names = getattr(getattr(x, "device_mesh", None), "mesh_dim_names", None) or ()
    if "model" not in names:
        return None
    m = names.index("model")
    return m if x.device_mesh.size(m) > 1 and x.placements[m].is_replicate() else None


class _SequenceSlice:
    """A layer's input replicated over "model", as block remat keeps it:
    whole while the layer's forward pass runs, then (:meth:`cut`) only this
    rank's slice of its sequence over "model", cut from the replica with no
    collective.  When the backward pass recomputes the layer, :meth:`get`
    all-gathers the slice over "model".  Every rank of a "model" group
    holds the same input, so the group keeps it once among its ranks
    instead of once on each (the whole inputs of llama3-70b's 80 layers
    are 86 GB a rank in its single-pod train cell).  The recompute reads
    the input through this object, not as an argument of the checkpoint,
    which would hold it whole until the backward pass."""

    def __init__(self, x: torch.Tensor):
        self.x, self.piece = x, None

    def get(self) -> torch.Tensor:
        if self.x is not None:
            return self.x
        x = self.piece.redistribute(self.piece.device_mesh, self.placements)
        return x.requires_grad_(self.requires_grad)  # the recompute saves what the forward pass saved

    def cut(self) -> None:
        from torch.distributed.tensor import DTensor, Shard

        x, self.x = self.x, None
        self.placements, self.requires_grad = x.placements, x.requires_grad
        cut = list(x.placements)
        cut[_model_dim(x)] = Shard(1)
        with torch.no_grad():
            local = x.detach().redistribute(x.device_mesh, cut).to_local().clone()
        self.piece = DTensor.from_local(local, x.device_mesh, cut, run_check=False,
                                        shape=x.shape, stride=x.stride())


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ArchConfig, device, lead=()) -> PyTree:
    """One block's parameters, stacked on ``lead`` (``()`` for a single
    block, as zamba2's shared block)."""
    dtype = _torch_dtype(cfg.param_dtype)
    p = {
        "norm_attn": init_norm(cfg, device, lead=lead),
        "attn": init_attention(gen, cfg, dtype, device, lead=lead),
    }
    if not cfg.parallel_block:
        p["norm_mlp"] = init_norm(cfg, device, lead=lead)
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, device, lead=lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, dtype, device, lead=lead)
    return p


def _ffn(p: PyTree, h: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The block's MLP, or its MoE layer with the layer's aux metrics."""
    if cfg.moe is not None:
        return moe_lib.apply_moe(p["moe"], h, cfg)
    return apply_mlp(p["mlp"], h, cfg), {}


def apply_block(
    p: PyTree,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    impl: str,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if cfg.parallel_block:
        # Command-R style: one pre-norm, attention and MLP in parallel.
        h = apply_norm(p["norm_attn"], x, cfg)
        attn_out = run_attention(p["attn"], h, cfg, positions, impl)
        mlp_out, aux = _ffn(p, h, cfg)
        return x + attn_out + mlp_out, aux
    h = apply_norm(p["norm_attn"], x, cfg)
    x = residual(x + run_attention(p["attn"], h, cfg, positions, impl))
    h = apply_norm(p["norm_mlp"], x, cfg)
    mlp_out, aux = _ffn(p, h, cfg)
    return x + mlp_out, aux


def apply_block_decode(
    p: PyTree,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ArchConfig,
    cache: Dict[str, torch.Tensor],
    position: int,
    write_pos: int,
) -> torch.Tensor:
    h = apply_norm(p["norm_attn"], x, cfg)
    attn_out = run_attention_decode(p["attn"], h, cfg, cache, position, write_pos)
    if cfg.parallel_block:
        return x + attn_out + _ffn(p, h, cfg)[0]
    x = x + attn_out
    h = apply_norm(p["norm_mlp"], x, cfg)
    return x + _ffn(p, h, cfg)[0]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig, device) -> PyTree:
    """Random parameters drawn on ``device`` from ``gen`` (a generator on
    that device).  The draws cannot match JAX's; parity tests convert JAX's
    parameters instead."""
    dtype = _torch_dtype(cfg.param_dtype)
    p: Dict[str, PyTree] = {
        "layers": init_block(gen, cfg, device, lead=(cfg.n_layers,)),
        "final_norm": init_norm(cfg, device),
    }
    if cfg.frontend != "audio":
        p["embed"] = embed_init(gen, (cfg.padded_vocab_size, cfg.d_model), dtype, device)
    if cfg.n_codebooks > 1:
        p["lm_heads"] = embed_init(
            gen, (cfg.n_codebooks, cfg.d_model, cfg.padded_vocab_size), dtype, device
        )
    elif not cfg.tied_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab_size), dtype, device)
    return p


def embed_inputs(
    p: PyTree, cfg: ArchConfig, batch: Dict[str, torch.Tensor], decode: bool = False
) -> torch.Tensor:
    """Token / frontend embedding.  Returns (B, S, d) activations."""
    dtype = _torch_dtype(cfg.activation_dtype)
    if cfg.frontend == "audio":
        # stub frontend: precomputed EnCodec frame embeddings
        return batch["frame_embeds"].to(dtype)
    x = lookup(p["embed"], batch["tokens"]).to(dtype)
    if cfg.frontend == "vlm" and not decode:
        # stub frontend: precomputed InternViT patch embeddings prepended
        # (full forward only: in decode the patches are already in the cache)
        x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)
    return x


def logits_from_hidden(p: PyTree, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.n_codebooks > 1:
        return torch.einsum("bsd,qdv->bsqv", h, p["lm_heads"])
    head = p["embed"].T if cfg.tied_embeddings else p["lm_head"]
    return h @ head


def forward(
    p: PyTree,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    impl: str = "torch",
    remat: str = "block",
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill forward pass.  Returns (logits, aux), or the
    final-normed hidden states in place of the logits with
    ``return_hidden``; aux holds each MoE metric averaged over layers (empty
    without MoE)."""
    x = embed_inputs(p, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    body = remat_body(apply_block, remat)
    per_layer: List[Dict[str, torch.Tensor]] = []
    for layer_p in unstack(p["layers"]):
        x, aux = body(*on_layer(layer_p, x), cfg, positions, impl)
        per_layer.append(aux)
    x = apply_norm(p["final_norm"], residual(x), cfg)
    aux_mean = {k: torch.stack([a[k] for a in per_layer]).mean() for k in per_layer[0]}
    if return_hidden:
        return x, aux_mean
    return logits_from_hidden(p, cfg, x), aux_mean


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> PyTree:
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = _torch_dtype(cfg.activation_dtype)
    cache_len = max_len
    if cfg.sliding_window is not None:
        cache_len = min(max_len, cfg.sliding_window)
    shape = (cfg.n_layers, batch, cache_len, K, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_step(
    p: PyTree,
    cfg: ArchConfig,
    cache: PyTree,
    batch: Dict[str, torch.Tensor],  # tokens: (B, 1) (or frame_embeds (B, 1, d))
    position: int,  # current write index
) -> Tuple[torch.Tensor, PyTree]:
    """One token of autoregressive decoding with a per-layer KV cache.

    The cache is updated in place and returned (JAX returns a new one); a
    full-width cache is the largest buffer of a serving run after the
    weights, and a copy per token would double it.
    """
    x = embed_inputs(p, cfg, batch, decode=True)
    if cfg.sliding_window is not None:
        write_pos = position % cache["k"].shape[2]  # ring buffer
    else:
        write_pos = position
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x = apply_block_decode(
            layer_params(p["layers"], i), x, cfg, layer_cache, position, write_pos
        )
    x = apply_norm(p["final_norm"], x, cfg)
    return logits_from_hidden(p, cfg, x), cache
