"""Sharding rules: parameter / batch / cache partition specs per arch
(port of ``repro.distributed.sharding``), and their DTensor placements.

Policy (Megatron-TP x ZeRO-FSDP hybrid, the standard large-model recipe):

* "model" axis — tensor parallelism: attention heads, FFN hidden, experts
  (expert parallelism when E divides the axis), vocab where divisible.
* fsdp axes ("pod", "data" on the multi-pod mesh) — parameters and optimizer
  state sharded on a non-TP dimension (ZeRO-3).
* batch is sharded over the fsdp axes (pure data parallelism for
  activations).

Every rule degrades gracefully: a dimension is sharded only when divisible
by the full axis size, otherwise it is replicated (e.g. InternVL2's 14
heads on a 16-way model axis).  KV caches fall back to sequence sharding
when kv_heads don't divide the model axis.

A spec is a PartitionSpec-style tuple with one entry per tensor dimension:
``None``, a mesh-axis name, or a tuple of names (the fsdp group).  A mesh is
a mapping of axis sizes or a :class:`~torch.distributed.device_mesh.DeviceMesh`
with named dimensions.  :func:`placements` turns a spec into the DTensor
placements of that mesh; :func:`shard_shape` and :func:`shard_bytes` give
one rank's local shape and the bytes of a tree of specs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch import tree
from repro_torch.configs.base import ArchConfig

__all__ = [
    "P",
    "ShardingRules",
    "axis_size",
    "mesh_axis_sizes",
    "named",
    "placements",
    "shard_bytes",
    "shard_shape",
    "validate_partition_spec",
]

PyTree = Any
Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """A spec of these entries, in JAX ``PartitionSpec``'s canonical form: a
    one-axis tuple becomes the axis name and an empty tuple ``None``."""
    def canon(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(canon(e) for e in entries)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mapping of sizes or a named ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("the mesh needs named dimensions (mesh_dim_names)")
    return dict(zip(names, mesh.shape))


def axis_size(mesh, name) -> int:
    """Size of one mesh axis, of a tuple of axes (their product) or of
    ``None`` (1)."""
    if name is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    if isinstance(name, tuple):
        return math.prod(sizes[n] for n in name)
    return sizes[name]


def _shard_if(dim: int, axis, mesh):
    return axis if axis is not None and dim % axis_size(mesh, axis) == 0 else None


def _flatten_spec_axes(spec) -> List[str]:
    """Mesh-axis names referenced by one PartitionSpec-style entry tuple."""
    flat = []
    for entry in spec:
        if entry is None:
            continue
        flat.extend(entry if isinstance(entry, tuple) else (entry,))
    return flat


def validate_partition_spec(spec: Sequence, mesh_axes: Union[Mapping[str, int], Iterable[str]]) -> None:
    """Reject ill-formed PartitionSpec-style rules.

    ``mesh_axes`` is the mesh's axis-name collection (a dict of sizes or an
    iterable of names).  Raises ``ValueError`` when a mesh axis is reused
    across dimensions (or twice within one dimension group), since a cost
    model fed such a rule double-counts the axis, and when a rule
    references an axis that does not exist on the mesh.

    >>> validate_partition_spec((("data", "fsdp"), "tensor"), ["data", "fsdp", "tensor"])
    >>> validate_partition_spec(("data", "data"), {"data": 2})
    Traceback (most recent call last):
    ...
    ValueError: partition spec ('data', 'data') reuses mesh axes ['data'] across conflicting tensor dimensions
    """
    names = tuple(mesh_axes)
    known = set(names)
    flat = _flatten_spec_axes(spec)
    unknown = [a for a in flat if a not in known]
    if unknown:
        raise ValueError(
            f"partition spec {tuple(spec)} references axes {unknown} absent "
            f"from mesh axes {names}"
        )
    if len(flat) != len(set(flat)):
        dupes = sorted({a for a in flat if flat.count(a) > 1})
        raise ValueError(
            f"partition spec {tuple(spec)} reuses mesh axes {dupes} across "
            f"conflicting tensor dimensions"
        )


class ShardingRules:
    """Computes partition specs for a (cfg, mesh) pair."""

    def __init__(self, cfg: ArchConfig, mesh, fsdp_axes: Optional[Tuple[str, ...]] = None,
                 model_axis: str = "model", zero_stage: int = 3):
        """``zero_stage``: 3 = params+optimizer FSDP-sharded (default);
        1 = params replicated over the data axes (TP-sharded only), optimizer
        moments still FSDP-sharded."""
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.zero_stage = zero_stage
        names = tuple(self.sizes)
        if fsdp_axes is None:
            fsdp_axes = tuple(n for n in names if n != model_axis)
        unknown = [a for a in fsdp_axes if a not in names]
        if unknown:
            raise ValueError(
                f"fsdp_axes {tuple(fsdp_axes)} reference axes {unknown} absent "
                f"from mesh axes {names}"
            )
        if model_axis in names and model_axis in fsdp_axes:
            raise ValueError(
                f"model_axis {model_axis!r} also appears in fsdp_axes "
                f"{tuple(fsdp_axes)}: one mesh axis cannot shard both a "
                f"tensor-parallel dimension and the FSDP dimension of the "
                f"same parameter (the rules would emit conflicting specs "
                f"with silently wrong collective volumes)"
            )
        if len(set(fsdp_axes)) != len(tuple(fsdp_axes)):
            raise ValueError(f"fsdp_axes {tuple(fsdp_axes)} repeat a mesh axis")
        self.fsdp: Tuple[str, ...] = tuple(fsdp_axes)
        self.model = model_axis if model_axis in names else None

    # -- helpers ---------------------------------------------------------------
    def fs(self, dim: int):
        """fsdp sharding for a dimension (whole group or nothing)."""
        if self.zero_stage < 3:
            return None
        return _shard_if(dim, self.fsdp, self.sizes)

    def fs_opt(self, dim: int):
        """Optimizer-state sharding (always FSDP: ZeRO-1 keeps moments sharded)."""
        return _shard_if(dim, self.fsdp, self.sizes)

    def opt_specs(self, params_shapes: PyTree) -> PyTree:
        """Optimizer-moment specs: FSDP-sharded regardless of zero stage."""
        if self.zero_stage >= 3:
            return self.params_specs(params_shapes)
        full = ShardingRules(
            self.cfg, self.mesh, self.fsdp,
            self.model if self.model is not None else "__none__",
            zero_stage=3,
        )
        return full.params_specs(params_shapes)

    def tp(self, dim: int):
        return _shard_if(dim, self.model, self.sizes)

    def dp_spec(self) -> Tuple[str, ...]:
        return self.fsdp

    # -- parameters ---------------------------------------------------------------
    def param_spec(self, path: Tuple[Any, ...], shape: Tuple[int, ...]) -> Spec:
        """The spec of the leaf at ``path`` (the port's tree path: dict keys,
        which are JAX's) of shape ``shape``."""
        names = [str(p) for p in path]
        # leading stacked-layer dims are never sharded
        stack = 0
        if "layers" in names or "mamba_layers" in names:
            stack = 2 if "mamba_layers" in names else 1
        core = tuple(shape[stack:])
        leaf = names[-1] if names else ""
        spec = [None] * stack + list(self._core_spec(names, leaf, core))
        validate_partition_spec(spec, self.sizes)
        return P(*spec)

    def _core_spec(self, names, leaf, core) -> Sequence:
        if len(core) <= 1:
            return [None] * len(core)
        # embeddings / heads
        if leaf == "embed":
            V, d = core
            return [self.tp(V), self.fs(d)]
        if leaf in ("lm_head",):
            d, V = core
            return [self.fs(d), self.tp(V)]
        if leaf == "lm_heads":  # (nq, d, V)
            _, d, V = core
            return [None, self.fs(d), self.tp(V)]
        # attention
        if leaf == "wq":
            if len(core) == 3:
                d, H, hd = core
                return [self.fs(d), self.tp(H), None]
        if leaf in ("wk", "wv") and len(core) == 3:
            d, K, hd = core
            return [self.fs(d), self.tp(K), None]
        if leaf == "wo" and len(core) == 3:
            H, hd, d = core
            return [self.tp(H), None, self.fs(d)]
        if leaf in ("bq", "bk", "bv"):
            return [self.tp(core[0]), None]
        # MoE
        if "moe" in names:
            if leaf == "router":
                return [self.fs(core[0]), None]
            E = core[0]
            ep = self.tp(E)
            if leaf in ("wi", "wg"):  # (E, d, ff)
                _, d, ff = core
                if ep is not None:
                    return [ep, self.fs(d), None]
                return [None, self.fs(d), self.tp(ff)]
            if leaf == "wo":  # (E, ff, d)
                _, ff, d = core
                if ep is not None:
                    return [ep, None, self.fs(d)]
                return [None, self.tp(ff), self.fs(d)]
        # dense MLP (and rwkv channel mix wk/wv with 2D shapes)
        if leaf in ("wi", "wg") and len(core) == 2:
            d, ff = core
            return [self.fs(d), self.tp(ff)]
        if leaf == "wo" and len(core) == 2:
            ff, d = core
            return [self.tp(ff), self.fs(d)]
        if leaf == "wk" and len(core) == 2 and "channel_mix" in names:
            d, ff = core
            return [self.fs(d), self.tp(ff)]
        if leaf == "wv" and len(core) == 2 and "channel_mix" in names:
            ff, d = core
            return [self.tp(ff), self.fs(d)]
        # rwkv time mix square projections
        if leaf in ("wr", "wk", "wv", "wg") and len(core) == 2:
            d, d2 = core
            return [self.fs(d), self.tp(d2)]
        if leaf == "wo" and len(core) == 2:
            d2, d = core
            return [self.tp(d2), self.fs(d)]
        if leaf in ("wa", "wb"):
            return [self.fs(core[0]), None]
        # mamba projections
        if leaf == "in_proj":
            d, po = core
            return [self.fs(d), self.tp(po)]
        if leaf == "out_proj":
            d_in, d = core
            return [self.tp(d_in), self.fs(d)]
        # fallback: fsdp on the largest dim
        big = max(range(len(core)), key=lambda i: core[i])
        spec = [None] * len(core)
        spec[big] = self.fs(core[big])
        return spec

    def params_specs(self, params_shapes: PyTree) -> PyTree:
        return tree.unflatten(params_shapes, [
            self.param_spec(path, leaf.shape) for path, leaf in tree.leaves_with_path(params_shapes)
        ])

    # -- batches ---------------------------------------------------------------
    def batch_specs(self, batch_shapes: Dict[str, Any]) -> Dict[str, Spec]:
        out = {}
        for k, v in batch_shapes.items():
            shape = tuple(v.shape)
            dp = _shard_if(shape[0], self.fsdp, self.sizes)
            out[k] = P(*([dp] + [None] * (len(shape) - 1)))
        return out

    def logits_spec(self, ndim: int) -> Spec:
        """Sharding for the lm logits: batch over dp, vocab over model
        (only when the padded vocab divides the model axis)."""
        v_axis = self.tp(self.cfg.padded_vocab_size)
        return P(*([self.fsdp] + [None] * (ndim - 2) + [v_axis]))

    # -- caches ---------------------------------------------------------------
    def cache_spec(self, path: Tuple[Any, ...], shape: Tuple[int, ...]) -> Spec:
        leafname = str(path[-1])
        shape = tuple(shape)
        if leafname in ("k", "v"):
            # (L, B, S, K, hd) or zamba (G, B, S, K, hd)
            L, B, S, K, hd = shape
            dp = _shard_if(B, self.fsdp, self.sizes)
            k_axis = self.tp(K)
            s_axis = self.tp(S) if k_axis is None else None
            return P(None, dp, s_axis, k_axis, None)
        if leafname == "wkv":  # (L, B, H, P, P)
            _, B, H, _, _ = shape
            dp = _shard_if(B, self.fsdp, self.sizes)
            return P(None, dp, self.tp(H), None, None)
        if leafname == "ssm":  # (G, L, B, H, N, P)
            dp = _shard_if(shape[2], self.fsdp, self.sizes)
            return P(None, None, dp, self.tp(shape[3]), None, None)
        if leafname == "conv":  # (G, L, B, K-1, C)
            dp = _shard_if(shape[2], self.fsdp, self.sizes)
            return P(None, None, dp, None, self.tp(shape[4]))
        if leafname in ("shift_t", "shift_c"):  # (L, B, d)
            dp = _shard_if(shape[1], self.fsdp, self.sizes)
            return P(None, dp, None)
        return (None,) * len(shape)

    def cache_specs(self, cache_shapes: PyTree) -> PyTree:
        return tree.unflatten(cache_shapes, [
            self.cache_spec(path, leaf.shape) for path, leaf in tree.leaves_with_path(cache_shapes)
        ])


# ---------------------------------------------------------------------------
# Specs on a device mesh
# ---------------------------------------------------------------------------
def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on the named ``DeviceMesh``: one
    per mesh dimension, ``Replicate()`` unless a tensor dimension is sharded
    over it.  A tensor dimension sharded over a tuple of axes becomes
    ``Shard(d)`` on each of them, major axis first, which is GSPMD's order
    and DTensor's; the tuple must list them in the mesh's order.  A mesh
    dimension named ``"pod+data"`` is the flattened product of those axes
    and takes the tuple ``("pod", "data")`` whole."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "+".join(axes) in names:
            dims = [names.index("+".join(axes))]
        else:
            missing = [a for a in axes if a not in names]
            if missing:
                raise ValueError(f"spec {spec} references axes {missing} absent from mesh {tuple(names)}")
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {entry} lists mesh axes out of the mesh's order {tuple(names)}")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"spec {spec} shards two dimensions over mesh axis {names[m]!r}")
            out[m] = Shard(d)
    return tuple(out)


def shard_shape(spec: Spec, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """One rank's local shape of a tensor of ``shape`` under ``spec`` (every
    sharded dimension divided by its axes' size, which must divide it)."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape} has dimensions")
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = axis_size(mesh, entry)
        if dim % n:
            raise ValueError(f"dimension {dim} of {shape} does not divide over {entry} ({n})")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(spec_tree: PyTree, tensor_tree: PyTree, mesh) -> float:
    """Exact per-rank bytes of a tree of tensors (meta tensors do) under a
    tree of specs of the same structure."""
    total = 0
    for spec, t in zip(tree.leaves(spec_tree, is_leaf=_is_spec), tree.leaves(tensor_tree), strict=True):
        total += math.prod(shard_shape(spec, t.shape, mesh)) * t.element_size()
    return float(total)


def named(mesh, spec_tree: PyTree) -> PyTree:
    """Each spec of ``spec_tree`` as its placements on ``mesh``."""
    specs = tree.leaves(spec_tree, is_leaf=_is_spec)
    return tree.unflatten(spec_tree, [placements(s, mesh) for s in specs], is_leaf=_is_spec)


def _is_spec(node) -> bool:
    """A spec tuple (its entries are None, axis names or tuples of names),
    as opposed to a container of specs."""
    return isinstance(node, tuple) and not hasattr(node, "_fields") and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in node
    )
