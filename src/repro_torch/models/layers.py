"""Core neural layers: norms, rotary, GQA attention, MLPs (counterpart of
``repro.models.layers``).

All layers are plain functions over parameter dicts of tensors, with the
JAX package's parameter layout, so that parameters convert leaf for leaf.
Large products go to ``torch.matmul``, as the JAX package left them to XLA.

Attention paths:
* ``torch``  — online-softmax causal attention over KV blocks, the
               counterpart of ``attention_xla`` (computes the masked full
               scores, block by block); on the card, for bf16 tensors of a
               head dim the backward kernels take and no binding window,
               the flash kernels with a backward pass instead
               (:func:`takes_flash_backward`).
* ``banded`` — sliding-window attention over a static band per query block.
* ``flash``  — the hand-written CUDA kernel in ``repro_torch.kernels``
               (the plain version on the CPU); takes the place of ``pallas``.
* decode     — single-token attention against a KV cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ArchConfig

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initializers (float32 normals from an explicit generator, cast to dtype)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, shape, dtype, device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)


def pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) of a (B, S, ...) tensor at the end by
    ``pad`` steps (the chunked scans pad to a whole number of chunks)."""
    return F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back)
# ---------------------------------------------------------------------------
def init_norm(cfg: ArchConfig, device, lead=()) -> Params:
    d = cfg.d_model
    p = {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act.endswith("_glu"):
        return {"wi": (d, ff), "wg": (d, ff), "wo": (ff, d)}
    return {"wi": (d, ff), "wo": (ff, d)}


def init_mlp(gen, cfg: ArchConfig, dtype, device, lead=()) -> Params:
    shapes = mlp_param_shapes(cfg)
    return {
        name: dense_init(gen, shape[0], (*lead, *shape), dtype, device)
        for name, shape in sorted(shapes.items())
    }


def apply_mlp(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_act == "silu_glu":
        h = F.silu(h) * (x @ p["wg"])
    elif cfg.mlp_act == "gelu_glu":
        h = F.gelu(h, approximate="tanh") * (x @ p["wg"])  # jax.nn.gelu default
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    elif cfg.mlp_act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_act {cfg.mlp_act}")
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def init_attention(gen, cfg: ArchConfig, dtype, device, lead=()) -> Params:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, (*lead, d, H, hd), dtype, device),
        "wk": dense_init(gen, d, (*lead, d, K, hd), dtype, device),
        "wv": dense_init(gen, d, (*lead, d, K, hd), dtype, device),
        "wo": dense_init(gen, H * hd, (*lead, H, hd, d), dtype, device),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((*lead, H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((*lead, K, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((*lead, K, hd), dtype=dtype, device=device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one contiguous matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def qkv_project(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    with obs.trace("model.rope"):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _largest_divisor_at_most(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (block sizes must tile exactly)."""
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each KV head H/K times."""
    reps = n_heads // k.shape[2]
    return k if reps == 1 else k.repeat_interleave(reps, dim=2)


def attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: ArchConfig,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Online-softmax causal attention over KV blocks (``attention_xla``).

    q: (B, S, H, hd); k, v: (B, S, K, hd).  Returns (B, S, H, hd).
    """
    B, S, H, hd = q.shape
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    kv_block = _largest_divisor_at_most(S, min(kv_block, S))
    scale = 1.0 / math.sqrt(hd)
    qf = (q * scale).float()  # scaled in q's dtype, scored in f32 as XLA does
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, S, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, hd), dtype=torch.float32, device=q.device)
    for start in range(0, S, kv_block):
        kj = k[:, start : start + kv_block]
        vj = v[:, start : start + kv_block]
        kv_pos = start + torch.arange(kv_block, device=q.device)
        s = torch.einsum("bqhk,bshk->bqsh", qf, kj.float())
        mask = q_pos[:, None] >= kv_pos[None, :]
        if cfg.sliding_window is not None:
            mask &= q_pos[:, None] < kv_pos[None, :] + cfg.sliding_window
        s = s.masked_fill(~mask[None, :, :, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=2))
        p = torch.exp(s - m_new[:, :, None, :])
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=2)
        pv = torch.einsum("bqsh,bshk->bqhk", p.to(kj.dtype), vj).float()
        acc = acc * correction[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def attention_banded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: ArchConfig,
    q_block: int = 1024,
) -> torch.Tensor:
    """Sliding-window attention with a static band per query block.

    Each query block of length Bq attends keys in
    [blk_start - window, blk_start + Bq): a slice of static length
    window + Bq (clamped at 0).  Sub-quadratic: O(S * (window + Bq)).
    """
    window = cfg.sliding_window
    if window is None:
        raise ValueError("attention_banded needs cfg.sliding_window")
    B, S, H, hd = q.shape
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    q_block = _largest_divisor_at_most(S, min(q_block, S))
    band = min(window + q_block, S)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(S // q_block):
        q_i = q[:, i * q_block : (i + 1) * q_block]
        start_c = min(max(i * q_block - window, 0), S - band)
        k_band = k[:, start_c : start_c + band]
        v_band = v[:, start_c : start_c + band]
        q_pos = i * q_block + torch.arange(q_block, device=q.device)
        kv_pos = start_c + torch.arange(band, device=q.device)
        s = torch.einsum("bqhk,bshk->bqsh", (q_i * scale).float(), k_band.float())
        mask = (q_pos[:, None] >= kv_pos[None, :]) & (q_pos[:, None] < kv_pos[None, :] + window)
        s = s.masked_fill(~mask[None, :, :, None], NEG_INF)
        p = torch.softmax(s, dim=2)
        outs.append(torch.einsum("bqsh,bshk->bqhk", p.to(v_band.dtype), v_band))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_decode(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, K, hd)
    v_cache: torch.Tensor,
    length: Union[int, torch.Tensor],  # (B,) or scalar: valid cache entries
    cfg: ArchConfig,
) -> torch.Tensor:
    B, S, K, hd = k_cache.shape
    H = q.shape[2]
    reps = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, 1, K, reps, hd)
    s = torch.einsum("bqkrh,bskh->bqksr", qg, k_cache).float()
    pos = torch.arange(S, device=q.device)
    if isinstance(length, int):  # a fill, not a host-to-device copy (which syncs)
        length = torch.full((B, 1), length, device=q.device)
    else:
        length = length.to(q.device).broadcast_to((B,))[:, None]
    valid = pos[None, :] < length
    if cfg.sliding_window is not None and S > cfg.sliding_window:
        # linear (non-ring) cache longer than the window: mask old entries
        valid &= pos[None, :] >= length - cfg.sliding_window
    s = s.masked_fill(~valid[:, None, None, :, None], NEG_INF)
    p = torch.softmax(s, dim=3)
    out = torch.einsum("bqksr,bskh->bqkrh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def shard_index(t: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(this rank's shard of DTensor ``t``'s dimension ``dim``, the shards'
    size): the mesh dimensions that shard it split it in mesh order, the
    first into the largest pieces, as DTensor lays the shards out."""
    mesh = t.device_mesh
    index, n = 0, 1
    for m, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            index = index * mesh.size(m) + mesh.get_local_rank(m)
            n *= mesh.size(m)
    return index, t.shape[dim] // n


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  For DTensors (the dry-run) the lookup is Megatron's
    vocabulary-parallel one, on each rank's shards: the table keeps its
    vocabulary shards (its other dimension is gathered, ZeRO-3's gather),
    each rank looks up the ids of its shard of the ids that fall in its
    slice of the vocabulary (zero rows for the others), and the rows,
    partial over the mesh dimensions that shard the vocabulary, are reduced
    over them at once (the residual stream starts whole); the table's
    gradient is its shards' over those and partial over the mesh
    dimensions that shard the ids.  No rank holds the whole table."""
    if not hasattr(table, "placements"):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = ids.device_mesh
    tab = [Shard(0) if pl.is_shard(0) else Replicate() for pl in table.placements]
    rows = [Replicate() if t.is_shard() else pl for t, pl in zip(tab, ids.placements)]
    grad = [t if t.is_shard() else Partial() if pl.is_shard() else Replicate() for t, pl in zip(tab, rows)]
    table = table.redistribute(mesh, tab)
    index, size = shard_index(table, 0)

    def rows_of_slice(t, i):
        local = i - index * size
        hit = (local >= 0) & (local < size)
        return t[local.clamp(0, size - 1)] * hit[..., None].to(t.dtype)

    run = local_map(rows_of_slice, out_placements=[Partial() if t.is_shard() else pl for t, pl in zip(tab, rows)],
                    in_placements=(tab, rows), in_grad_placements=(grad, rows), device_mesh=mesh)
    return run(table, ids.redistribute(mesh, rows)).redistribute(mesh, rows)


def attention_on_shards(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    """``attend`` (``attention_torch`` or ``attention_banded``) on DTensor
    q, k, v, run on each rank's shards.  Attention is independent across
    batch rows and heads, so the KV heads are expanded to the query heads
    and q, k, v are laid out alike: batch shards kept, head shards kept
    where the mesh dimension divides the heads, every other dimension
    replicated.  DTensor cannot run the plain function's einsums itself: they
    merge a batch dimension sharded over one mesh dimension with a head
    dimension sharded over another."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    H = q.shape[2]
    k, v = _expand_kv(k, H), _expand_kv(v, H)
    mesh = q.device_mesh
    layout = [  # a list: local_map reads a tuple as one placement list per output
        pl if isinstance(pl, Shard) and (pl.dim == 0 or (pl.dim == 2 and H % mesh.size(i) == 0))
        else Replicate()
        for i, pl in enumerate(q.placements)
    ]
    q, k, v = (t.redistribute(mesh, layout) for t in (q, k, v))
    run = local_map(lambda q_, k_, v_: attend(q_, k_, v_, cfg), out_placements=layout,
                    in_placements=(layout, layout, layout), device_mesh=mesh)
    return run(q, k, v)


def scan_on_shards(scan, args, dims, out_dims, H: int):
    """``scan`` on DTensor ``args``, run on each rank's shards.  A scan (the
    SSD or the WKV recurrence) is independent across batch rows and heads,
    so each mesh dimension named "model" shards the heads where it divides
    ``H`` and every other mesh dimension shards the batch where it divides
    it (JAX's ``_shard_if`` on the cache specs, which GSPMD keeps through
    the scan); every other tensor dimension is replicated.  ``dims[i]`` is
    ``args[i]``'s (batch dimension, head dimension), either None;
    ``out_dims`` the same for each output.  A ``None`` argument passes
    through.  An argument replicated over a mesh dimension that splits the
    work (A, D, u; B and C under head shards) takes its gradient partial
    there: each rank's share of it comes from its own rows and heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ref, (bdim, _) = next((a, d) for a, d in zip(args, dims) if a is not None and d[0] is not None)
    mesh = ref.device_mesh
    splits = [("head" if H % mesh.size(m) == 0 else None) if name == "model"
              else ("batch" if ref.shape[bdim] % mesh.size(m) == 0 else None)
              for m, name in enumerate(mesh.mesh_dim_names)]

    def layout(d):
        return [Shard(d[0]) if s == "batch" and d[0] is not None
                else Shard(d[1]) if s == "head" and d[1] is not None else Replicate() for s in splits]

    def grad_layout(d):
        return [pl if pl.is_shard() or s is None else Partial() for pl, s in zip(layout(d), splits)]

    live = [a is not None for a in args]
    args = tuple(a.redistribute(mesh, layout(d)) if a is not None else None for a, d in zip(args, dims))
    run = local_map(scan, out_placements=tuple(layout(d) for d in out_dims),
                    in_placements=tuple(layout(d) if on else None for d, on in zip(dims, live)),
                    in_grad_placements=tuple(grad_layout(d) if on else None for d, on in zip(dims, live)),
                    device_mesh=mesh)
    return run(*args)


def attention_output(p: Params, ctx: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    H, hd, d = p["wo"].shape
    return ctx.reshape(*ctx.shape[:2], H * hd) @ p["wo"].reshape(H * hd, d)


def takes_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig) -> bool:
    """Whether the ``torch`` path's attention runs on the flash kernels
    with their backward pass (``kernels.attention.ops.FlashAttention``),
    by what the call shows: plain CUDA tensors (not DTensors), all bf16, a
    head dim in ``BWD_HEAD_DIMS`` and no window that binds.  Every other
    call (the CPU, the dry-run's DTensors, float32, other head dims,
    binding windows) keeps the plain PyTorch attention."""
    from repro_torch.kernels.attention.ops import BWD_HEAD_DIMS

    return (
        q.device.type == "cuda"
        and not any(hasattr(t, "placements") for t in (q, k, v))
        and q.dtype == k.dtype == v.dtype == torch.bfloat16
        and q.shape[-1] in BWD_HEAD_DIMS
        and (cfg.sliding_window is None or q.shape[1] <= cfg.sliding_window)
    )


def run_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    impl: str = "torch",
) -> torch.Tensor:
    """Full attention sublayer for train/prefill (the ``model.attention``
    span, ``model.rope`` inside it); ``impl="kernel"`` runs the flash
    kernel, and ``impl="torch"`` runs it too, with its statistics and
    backward kernels under autograd, where :func:`takes_flash_backward`
    says so (it is asked first, and alone decides that route)."""
    with obs.trace("model.attention"):
        q, k, v = qkv_project(p, x, cfg, positions)
        if impl == "torch" and takes_flash_backward(q, k, v, cfg):
            from repro_torch.kernels.attention import ops as flash_ops

            ctx = flash_ops.flash_attention_trainable(q, k, v)
        elif hasattr(q, "placements"):  # DTensors (the dry-run)
            banded = cfg.sliding_window is not None and x.shape[1] > cfg.sliding_window
            ctx = attention_on_shards(attention_banded if banded else attention_torch, q, k, v, cfg)
        elif cfg.sliding_window is not None and x.shape[1] > cfg.sliding_window:
            ctx = attention_banded(q, k, v, cfg)
        elif impl == "kernel":
            from repro_torch.kernels.attention import ops as flash_ops

            ctx = flash_ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
        elif impl == "torch":
            ctx = attention_torch(q, k, v, cfg)
        else:
            raise ValueError(f"unknown attention impl {impl!r} (torch | kernel)")
        return attention_output(p, ctx)


def run_attention_decode(
    p: Params,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ArchConfig,
    cache: Dict[str, torch.Tensor],  # this layer's (B, S, K, hd) views
    position: int,  # true sequence position (for rope)
    write_pos: Optional[int] = None,  # cache write index (ring buffers)
) -> torch.Tensor:
    """One token of attention.  Writes this token's k/v into ``cache`` in
    place (the JAX function returns an updated copy instead)."""
    write_pos = position if write_pos is None else write_pos
    positions = torch.arange(position, position + 1, device=x.device)  # no host copy
    q, k, v = qkv_project(p, x, cfg, positions)
    cache["k"][:, write_pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_pos] = v[:, 0].to(cache["v"].dtype)
    length = min(position + 1, cache["k"].shape[1])
    ctx = attention_decode(q, cache["k"], cache["v"], length, cfg)
    return attention_output(p, ctx)
