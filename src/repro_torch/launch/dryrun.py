"""Multi-pod dry-run: run rank 0's step of every (arch x shape x mesh) cell
on a fake production mesh (port of ``repro.launch.dryrun``).

For each cell the dry-run:
  1. builds the model and the step (train step / prefill / decode),
  2. makes every parameter, optimizer moment, cache and batch leaf a
     DTensor of its ``ShardingRules`` placements on the production mesh
     (:func:`repro_torch.launch.mesh.fake_production_mesh`: 256 or 512
     ranks of a fake process group, this process rank 0), each from a zero
     local shard of its exact local shape: no full tensor is ever built,
  3. runs the step once under a
     :class:`~repro_torch.analysis.roofline.CollectiveTrace` and a
     :class:`~repro_torch.analysis.roofline.LocalFlopCounter`: the values are meaningless, as JAX's
     ``ShapeDtypeStruct`` inputs are, but the local shards are real, so the
     device's peak allocated bytes are rank 0's peak (JAX's
     ``memory_analysis``), printed beside the exact shard bytes of the
     state; success proves the distribution config is coherent
     (divisibility, a sharding strategy for every op),
  4. derives roofline terms:
       - compute/memory: the exact analytic model
         (:mod:`repro_torch.analysis.analytic`),
       - collectives: traced in *calibration* runs at two depths (L0, L1)
         and one or two microbatch counts, and extrapolated with the exact
         bilinear model F(L, m) = a + b*L + c*m + d*L*m (:func:`bilinear`),
  5. writes a JSON record to ``build/dryrun/``, ``ok`` only when the local
     shards built hold the specs' state bytes and, on the card, the peak
     allocated bytes fit its memory (``checks`` lists what failed); the
     CLI exits non-zero for a cell that is not ``ok``.  A cell whose run
     runs out of the card's memory is recorded, not raised: ``ok`` false,
     the error in ``checks``, the bytes allocated when it failed and the
     request that failed, the state bytes and the analytic terms, and no
     collective figures.  A calibration run that runs out of memory (at
     one microbatch it holds more rows than the cell's own) leaves the
     production run's counts in place, with the error in ``notes`` and
     ``calibration_out_of_memory``.

A cell takes JAX's ``variant`` dict (``benchmarks/perf_hillclimb.py``'s
knobs): ``microbatches``, ``remat`` ("block"), ``loss_chunk`` (None),
``zero_stage`` (3), ``model_axis`` ("model"; "none" for none) and
``fsdp_axes`` (every other axis); ``tag`` names the record
``{arch}__{shape}__{mesh}__{tag}.json``, and the record keeps the dict as
``variant``.  Under ZeRO-1 (``zero_stage`` 1) the parameters are
replicated over the fsdp axes and their moments sharded there
(:func:`repro_torch.optim.adamw.update`); with no model axis the step runs
on a one-dimensional mesh of every fsdp axis (``"data+model"``).

The step runs on a two-dimensional mesh of the rules' groups, (the fsdp
axes flattened, "model"): on the multi-pod mesh ("pod", "data", "model")
every rule shards "pod" and "data" together, and DTensor plans the
redistribution of a dimension sharded over two mesh dimensions by a graph
search over placements, which is slow.  The rank layout is the production mesh's (row-major), and
a collective over the flattened group is attributed to "pod+data", as JAX
attributes one over the fsdp replica groups.

DTensor chooses its own redistributions, so the traced collective counts
and bytes are not XLA's.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k --mesh single --link-bw 50e9
  python -m repro_torch.launch.dryrun --all --mesh both --link-bw 50e9
  python -m repro_torch.launch.dryrun --all --mesh both --link-bw 50e9 --force --part 1/3   # a third of it
  python -m repro_torch.launch.dryrun --arch rwkv6-3b --shape train_4k --mesh single --link-bw 50e9 \
      --variant '{"tag": "opt4", "zero_stage": 1, "model_axis": "none", "fsdp_axes": ["data", "model"]}'
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.analysis import analytic, roofline
from repro_torch.analysis.axis_attribution import per_axis_collectives
from repro_torch.configs import SHAPES, all_archs, cells, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (
    ShardingRules,
    mesh_axis_sizes,
    named,
    placements,
    shard_bytes,
    shard_shape,
)
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# Activation-memory knob per arch for train_4k (microbatch count).
MICROBATCHES = {
    "nemotron-4-340b": 8,
    "qwen1.5-110b": 4,
    "command-r-35b": 4,
    "mixtral-8x7b": 4,
    "phi3.5-moe-42b-a6.6b": 4,
    "granite-3-8b": 2,
    "musicgen-large": 2,
    "zamba2-2.7b": 2,
    "rwkv6-3b": 2,
    "internvl2-1b": 1,
}

# The hill-climb's cells and variants, verbatim from the JAX package's
# ``benchmarks/perf_hillclimb.py`` (``tools/perf_hillclimb.py`` runs them).
HILLCLIMB_CELLS = [
    ("nemotron-4-340b", "train_4k", "single"),
    ("rwkv6-3b", "train_4k", "single"),
    ("mixtral-8x7b", "train_4k", "single"),
]

HILLCLIMB_VARIANTS = {
    "baseline2": {"tag": "baseline2"},  # re-measure with bilinear calibration
    "opt1": {
        "nemotron-4-340b": {"tag": "opt1", "microbatches": 2, "remat": "dots", "loss_chunk": 512},
        "rwkv6-3b": {"tag": "opt1", "microbatches": 1, "remat": "dots", "loss_chunk": 512},
        "mixtral-8x7b": {"tag": "opt1", "microbatches": 2, "remat": "dots", "loss_chunk": 512},
    },
    # opt2: ZeRO-1 for archs whose bf16 params fit per-device after TP
    # (kills the FSDP weight/activation gathers); nemotron cannot (42 GB/dev)
    # so it keeps ZeRO-3 with remat=block (undo the opt1 memory explosion)
    # and chunked CE.
    "opt2": {
        "nemotron-4-340b": {"tag": "opt2", "microbatches": 4, "remat": "block", "loss_chunk": 512},
        "rwkv6-3b": {"tag": "opt2", "microbatches": 1, "remat": "block", "loss_chunk": 512, "zero_stage": 1},
        "mixtral-8x7b": {"tag": "opt2", "microbatches": 2, "remat": "block", "loss_chunk": 512, "zero_stage": 1},
    },
    # opt3: best-of combinations — nemotron: opt1's microbatch cut without
    # the remat=dots memory explosion; mixtral: back to ZeRO-3 with the
    # microbatch cut + chunked CE.
    "opt3": {
        "nemotron-4-340b": {"tag": "opt3", "microbatches": 2, "remat": "block", "loss_chunk": 512},
        "rwkv6-3b": {"tag": "opt3", "microbatches": 1, "remat": "block", "loss_chunk": 512, "zero_stage": 1},
        "mixtral-8x7b": {"tag": "opt3", "microbatches": 2, "remat": "block", "loss_chunk": 512},
    },
    # opt4 (rwkv6 only): the arch is attention-free and fits per device —
    # tensor parallelism is pure overhead.  Pure 256-way DP (batch over both
    # mesh axes), ZeRO-1 params, sharded moments: the model-axis collectives
    # disappear; only the gradient all-reduce remains.
    "opt4": {
        "rwkv6-3b": {"tag": "opt4", "microbatches": 1, "remat": "block",
                      "loss_chunk": 512, "zero_stage": 1,
                      "model_axis": "none", "fsdp_axes": ["data", "model"]},
        "nemotron-4-340b": {"tag": "opt4", "microbatches": 2, "remat": "block", "loss_chunk": 512},
        "mixtral-8x7b": {"tag": "opt4", "microbatches": 2, "remat": "block", "loss_chunk": 512},
    },
}


def hillclimb_variant(name: str, arch_name: str) -> dict:
    """The variant dict one hill-climb cell takes (JAX's lookup: per arch
    where the variant names archs, else the variant itself)."""
    v = HILLCLIMB_VARIANTS[name]
    return dict(v[arch_name] if arch_name in v else v)


def batch_shapes(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The cell's inputs as meta tensors (JAX's ``batch_specs_struct``)."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *s, dtype: torch.empty(s, dtype=dtype, device="meta")
    f32, i32 = torch.float32, torch.int32
    if shape.is_decode:
        if arch.frontend == "audio":
            return {"frame_embeds": meta(B, 1, arch.d_model, dtype=f32)}
        return {"tokens": meta(B, 1, dtype=i32)}
    if arch.frontend == "audio":
        return {
            "frame_embeds": meta(B, S, arch.d_model, dtype=f32),
            "targets": meta(B, S, arch.n_codebooks, dtype=i32),
        }
    out = {"tokens": meta(B, S, dtype=i32)}
    if arch.frontend == "vlm":
        out["patch_embeds"] = meta(B, arch.num_patches, arch.d_model, dtype=f32)
    return out


def run_mesh(mesh, rules: ShardingRules):
    """The DeviceMesh the step runs on: ``mesh``'s ranks with the fsdp axes
    flattened into one dimension named ``"+".join(fsdp)``, then the model
    axis (when the rules have one)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    groups = [rules.fsdp] + ([(rules.model,)] if rules.model else [])
    order = [names.index(a) for g in groups for a in g]
    if sorted(order) != list(range(len(names))):
        raise ValueError(f"the rules' axes {groups} do not cover the mesh axes {names} once each")
    ranks = mesh.mesh.permute(order).reshape([math.prod(mesh.size(names.index(a)) for a in g)
                                              for g in groups])
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=tuple("+".join(g) for g in groups))


def _zero_shards(specs, shapes, sizes, rmesh, device: torch.device, dtype=None):
    """A tree of DTensors like ``shapes`` (meta tensors), each a zero local
    shard of its spec's local shape (``dtype`` overrides the leaves')."""
    from torch.distributed.tensor import DTensor

    def make(spec, t):
        local = torch.zeros(shard_shape(spec, t.shape, sizes), dtype=dtype or t.dtype, device=device)
        return DTensor.from_local(local, rmesh, placements(spec, rmesh), run_check=False,
                                  shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())

    spec_leaves = tree.leaves(specs, is_leaf=lambda n: isinstance(n, tuple))
    return tree.unflatten(shapes, [make(s, t) for s, t in zip(spec_leaves, tree.leaves(shapes), strict=True)])


class Zero3Views(TorchDispatchMode):
    """The dry-run's three rules on top of DTensor's own sharding propagation.

    * ZeRO-3: an op that takes a parameter (a DTensor sharing storage with
      one of ``params``, views included) takes it gathered over the fsdp
      mesh dimension, as XLA gathers an FSDP-sharded weight before its use;
      left to itself, DTensor may instead gather the activations and
      contract over the sharded weight dimension (on granite's train cell:
      the whole batch on every rank).  A view of a parameter (a layer of a
      stack, a transpose) is not gathered; the op that uses it is, so no
      rank gathers a whole stack.  The gather runs below autograd, so each
      use gathers anew (remat's recompute and the backward pass too) and
      the gradient comes back partial, to be reduce-scattered to the
      parameter's shards (``models.transformer.on_layer``, layer by layer).
    * Megatron's activation layout: the other operand of a product with a
      parameter (``mm``, ``addmm``, ``bmm``) is taken with its rows sharded
      over the fsdp mesh dimension, as the batch is sharded, and over each
      other mesh dimension with its contraction dimension sharded where
      the weight's is (a row-parallel product, whose partial sums the
      forward pass reduces at once, Megatron's all-reduce; left partial,
      they would be reduced again by every op that reads them) and
      replicated otherwise.
      DTensor's cost model, left to itself, may replicate the batch (on
      granite's train cell: every token of the global batch through the
      head on each rank) or gather the weight over "model".
    * Views: before a view or reshape, the input is replicated over each
      mesh dimension whose shard the view cannot keep: a shard of a
      dimension the view merges into its left neighbour, or one it splits
      or merges unevenly (as 8 KV heads over 16 ranks).  The decision is
      made from the shapes and placements, by the rule DTensor's view
      propagation applies (a merge keeps the shard of its leftmost
      dimension, a split that of its leftmost piece, each only when it
      divides evenly); GSPMD pads or reshards such a view, here the tensor
      is gathered, which the trace counts.  ``replications`` counts them by
      op and mesh dimension.
    """

    VIEWS = ("view", "_unsafe_view", "reshape")
    PRODUCTS = ("mm", "addmm", "bmm")

    def __init__(self, params, fsdp_dim: int):
        super().__init__()
        self.storages = {t.to_local().untyped_storage().data_ptr() for t in tree.leaves(params)}
        self.fsdp_dim = fsdp_dim
        self.gathers = 0
        self.replications: Dict[str, int] = {}

    def _is_param(self, a) -> bool:
        from torch.distributed.tensor import DTensor

        return isinstance(a, DTensor) and a.to_local().untyped_storage().data_ptr() in self.storages

    def _megatron(self, a, w):
        """``a``, the other operand of a product with the parameter ``w``,
        with its rows (dimension -2) sharded over the fsdp mesh dimension
        and, over each other mesh dimension, its contraction dimension
        sharded where ``w``'s is (a row-parallel product) and replicated
        otherwise."""
        from torch.distributed.tensor import Replicate, Shard

        want = [Shard(a.dim() - 1) if pl == Shard(w.dim() - 2) else Replicate() for pl in w.placements]
        want[self.fsdp_dim] = Shard(a.dim() - 2)
        return a if tuple(want) == tuple(a.placements) else a.redistribute(a.device_mesh, want)

    def _gathered(self, a):
        from torch.distributed.tensor import Replicate

        if not self._is_param(a) or not a.placements[self.fsdp_dim].is_shard():
            return a
        self.gathers += 1
        kept = list(a.placements)
        kept[self.fsdp_dim] = Replicate()
        # detached: the gather is below autograd, and a parameter's view
        # that requires grad, gathered in the backward pass, makes torch
        # 2.11's autograd.Function call detach_, which DTensor has no rule for
        return a.detach().redistribute(a.device_mesh, kept)

    def _viewable(self, op: str, t, size):
        """``t`` replicated over the mesh dimensions whose shards a view of
        it to ``size`` cannot keep (:func:`view_keeps_shard`), laid out
        contiguously on each rank."""
        from torch.distributed.tensor import DTensor, Replicate

        if not t.to_local().is_contiguous():
            # DTensor's strides are the global tensor's; a view of a local
            # shard that an op left strided needs it laid out as they say
            t = DTensor.from_local(t.to_local().contiguous(), t.device_mesh, t.placements,
                                   run_check=False, shape=t.shape, stride=t.stride())
        mesh_sizes = [t.device_mesh.size(m) for m in range(t.device_mesh.ndim)]
        drop = [m for m, pl in enumerate(t.placements)
                if pl.is_shard() and not view_keeps_shard(tuple(t.shape), size, t.placements, mesh_sizes, m)]
        if not drop:
            return t
        kept = list(t.placements)
        for m in drop:
            key = f"{op}@{t.device_mesh.mesh_dim_names[m]}"
            self.replications[key] = self.replications.get(key, 0) + 1
            kept[m] = Replicate()
        return t.redistribute(t.device_mesh, kept)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        forward_product = False
        if func._opname in self.PRODUCTS:
            i = 1 if func._opname == "addmm" else 0  # addmm(bias, a, w)
            if self._is_param(args[i + 1]) and not self._is_param(args[i]):
                args = args[:i] + (self._megatron(args[i], args[i + 1]),) + args[i + 1:]
                # the forward pass (remat's recompute included), not the
                # backward's products with the weight
                forward_product = torch._C._current_graph_task_id() == -1 or torch.is_grad_enabled()
        if not func.is_view:  # a view of a parameter (a layer of the stack) is gathered where it is used
            args = tuple([self._gathered(x) for x in a] if isinstance(a, (list, tuple)) else self._gathered(a)
                         for a in args)
        if func._opname in self.VIEWS:
            args = (self._viewable(func._opname, args[0], args[1]),) + args[1:]
        out = func(*args, **kwargs)
        return self._reduced(out) if forward_product else out

    @staticmethod
    def _reduced(out):
        """A forward product's partial sums (a row-parallel product's)
        reduced at once, Megatron's all-reduce at the end of the layer."""
        from torch.distributed.tensor import Replicate

        if not any(pl.is_partial() for pl in out.placements):
            return out
        return out.redistribute(out.device_mesh, [Replicate() if pl.is_partial() else pl for pl in out.placements])


def view_groups(src, dst) -> List[Tuple[List[int], List[int]]]:
    """The dimensions of a reshape from shape ``src`` to ``dst``, in
    pairs (input dims, output dims) whose sizes have equal products, each
    as short as it can be; a dimension of size 1 is a group of its own."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        if i < len(src) and src[i] == 1:
            groups.append(([i], []))
            i += 1
        elif j < len(dst) and dst[j] == 1:
            groups.append(([], [j]))
            j += 1
        else:
            ins, outs, a, b = [i], [j], src[i], dst[j]
            i, j = i + 1, j + 1
            while a != b:
                if a < b:
                    ins.append(i)
                    a *= src[i]
                    i += 1
                else:
                    outs.append(j)
                    b *= dst[j]
                    j += 1
            groups.append((ins, outs))
    return groups


def view_keeps_shard(src, size, placements_, mesh_sizes, m: int) -> bool:
    """Whether a view of a tensor of shape ``src`` and ``placements_`` to
    ``size`` (one entry may be -1) keeps the shard on mesh dimension ``m``:
    its tensor dimension maps to one output dimension unchanged, or leads
    its group (the leftmost dimension of a merge, the first piece of a
    split) and the mesh dimensions sharding it divide both that dimension
    and the first output dimension of the group."""
    numel = math.prod(src)
    dst = [int(n) for n in size]
    if -1 in dst:
        known = math.prod(n for n in dst if n != -1)
        dst[dst.index(-1)] = numel // known if known else 0
    d = placements_[m].dim
    ins, outs = next(g for g in view_groups(src, dst) if d in g[0])
    if len(ins) == 1 and len(outs) == 1:
        return True
    n = math.prod(mesh_sizes[k] for k, pl in enumerate(placements_) if pl.is_shard(d))
    return d == ins[0] and bool(outs) and src[d] % n == 0 and dst[outs[0]] % n == 0


@dataclasses.dataclass
class CellRun:
    """One run of a cell's step: what it traced and what its state holds."""

    trace: roofline.CollectiveTrace
    flops: Dict[str, float]  # rank 0's FLOPs (LocalFlopCounter)
    state_bytes: float  # exact per-rank bytes of the step's state, from the specs
    allocated_bytes: float  # the same, summed over the local shards the run built
    cache_bytes: float  # of which the decode cache
    params_shapes: Any  # the parameter tree on the meta device
    rmesh: Any  # the DeviceMesh the step ran on
    view_replications: Dict[str, int]  # Zero3Views' replications before a view
    param_gathers: int  # Zero3Views' parameter gathers


def cell_state_bytes(arch: ArchConfig, shape: ShapeConfig, rules: ShardingRules) -> Tuple[float, float]:
    """(exact per-rank bytes of the step's state, of which the decode
    cache) from the specs alone: params + grads (bf16) + m + v (float32)
    for a train cell, the parameters for prefill, parameters and cache for
    decode."""
    model = build_model(arch)
    params_shapes = model.init_shapes()
    param_specs = rules.params_specs(params_shapes)
    params = shard_bytes(param_specs, params_shapes, rules.sizes)
    if shape.kind == "train":
        f32 = tree.tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"), params_shapes)
        return 2 * params + 2 * shard_bytes(rules.opt_specs(params_shapes), f32, rules.sizes), 0.0
    if shape.kind == "prefill":
        return params, 0.0
    cache_shapes = model.cache_shapes(shape.global_batch, shape.seq_len)
    cache = shard_bytes(rules.cache_specs(cache_shapes), cache_shapes, rules.sizes)
    return params + cache, cache


def cell_rules(arch: ArchConfig, mesh, variant: Optional[dict] = None) -> ShardingRules:
    """The cell's ``ShardingRules`` under ``variant``'s sharding knobs, as
    JAX's ``_lower_cell`` builds them."""
    variant = variant or {}
    fsdp = variant.get("fsdp_axes")
    return ShardingRules(arch, mesh_axis_sizes(mesh), zero_stage=variant.get("zero_stage", 3),
                         model_axis=variant.get("model_axis", "model"),
                         fsdp_axes=tuple(fsdp) if fsdp else None)


def cell_microbatches(arch: ArchConfig, shape: ShapeConfig, variant: Optional[dict] = None) -> int:
    """The cell's microbatch count: the variant's, else ``MICROBATCHES``
    for a train cell and 1 for the others (JAX's ``run_cell``)."""
    mb = MICROBATCHES.get(arch.name, 1) if shape.kind == "train" else 1
    return (variant or {}).get("microbatches", mb)


def cell_model(arch: ArchConfig, variant: Optional[dict] = None, **fields):
    """The cell's model under ``variant``'s ``remat`` and ``loss_chunk``
    (JAX's ``build_model`` and ``dataclasses.replace``), with ``fields``."""
    variant = variant or {}
    return dataclasses.replace(build_model(arch, remat=variant.get("remat", "block")),
                               loss_chunk=variant.get("loss_chunk"), **fields)


def _run_cell(arch, shape, mesh, rmesh, *, microbatches, variant: Optional[dict] = None,
              device: DeviceLike = "cuda") -> CellRun:
    """Build and run rank 0's step of one cell once, on ``rmesh``
    (:func:`run_mesh` of ``mesh``), under ``variant``'s knobs."""
    from torch.distributed.tensor.experimental import implicit_replication

    dev = resolve_device(device)
    sizes = mesh_axis_sizes(mesh)
    rules = cell_rules(arch, sizes, variant)
    model = cell_model(arch, variant, logits_sharding=lambda ndim: placements(rules.logits_spec(ndim), rmesh))
    params_shapes = model.init_shapes()
    param_specs = rules.params_specs(params_shapes)
    params = _zero_shards(param_specs, params_shapes, sizes, rmesh, dev)
    batch_meta = batch_shapes(arch, shape)
    batch = _zero_shards(rules.batch_specs(batch_meta), batch_meta, sizes, rmesh, dev)
    trace = roofline.CollectiveTrace()
    counter = roofline.LocalFlopCounter()
    views = Zero3Views(params, fsdp_dim=0)
    with implicit_replication():
        if shape.kind == "train":
            moment_specs = rules.opt_specs(params_shapes)
            moments = lambda: _zero_shards(moment_specs, params_shapes, sizes, rmesh, dev, torch.float32)
            opt_state = adamw.AdamWState(torch.zeros((), dtype=torch.int32, device=dev), moments(), moments())
            step_fn = make_train_step(model, adamw.AdamWConfig(), microbatches=microbatches,
                                      grad_placements=named(rmesh, param_specs))
            with counter, trace, views:
                step_fn(params, opt_state, batch)
        elif shape.kind == "prefill":
            with torch.no_grad(), counter, trace, views:
                logits, _ = model.forward(params, batch)
                logits[:, -1]
        else:  # decode
            cache_shapes = model.cache_shapes(shape.global_batch, shape.seq_len)
            cache = _zero_shards(rules.cache_specs(cache_shapes), cache_shapes, sizes, rmesh, dev)
            with torch.no_grad(), counter, trace, views:
                model.decode_step(params, cache, batch, shape.seq_len - 1)
    # the bytes of the local shards this run allocated (grads: as the params)
    local = lambda t: sum(x.to_local().nbytes for x in tree.leaves(t))
    allocated = local(params)
    if shape.kind == "train":
        allocated = 2 * allocated + local(opt_state.m) + local(opt_state.v)
    elif shape.kind == "decode":
        allocated += local(cache)
    state_bytes, cache_bytes = cell_state_bytes(arch, shape, rules)
    return CellRun(trace, counter.counts(), state_bytes, float(allocated), cache_bytes, params_shapes, rmesh,
                   views.replications, views.gathers)


def _calib_depths(arch):
    if arch.shared_attn_every:
        step = arch.shared_attn_every
        return step, 2 * step, arch.n_layers // step, 1  # L0, L1, units_full, per
    return 2, 4, arch.n_layers, None


def bilinear(measurements: Dict[Tuple[int, int], float], L0: int, L1: int, Lf: int, mb: int) -> float:
    """The exact bilinear calibration F(L, m) = a + b*L + c*m + d*L*m,
    evaluated at depth ``Lf`` and ``mb`` microbatches.

    ``measurements`` maps (depth, microbatches) to the measured value at
    (L0, 1), (L1, 1) and, for the bilinear model, (L0, 2) and (L1, 2);
    without the microbatch-2 points the model is linear in depth (prefill
    and decode cells).  Negative extrapolations are clipped to 0."""
    f00 = measurements[(L0, 1)]
    f10 = measurements[(L1, 1)]
    if (L0, 2) not in measurements:
        slope = (f10 - f00) / (L1 - L0)
        return max(0.0, f00 + slope * (Lf - L0))
    f01 = measurements[(L0, 2)]
    f11 = measurements[(L1, 2)]
    d = (f11 - f01 - f10 + f00) / (L1 - L0)
    b = (f10 - f00) / (L1 - L0) - d
    c = f01 - f00 - d * L0
    a = f00 - b * L0 - c - d * L0
    return max(0.0, a + b * Lf + c * mb + d * Lf * mb)


def card_info() -> Dict[str, Any]:
    """The card's name and power limit as nvidia-smi prints them (None
    without a card)."""
    if not torch.cuda.is_available():
        return {"name": None, "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def record_path(arch_name: str, shape_name: str, mesh_kind: str, variant: Optional[dict] = None) -> Path:
    """Where a cell's record goes: ``{arch}__{shape}__{mesh}.json``, with
    ``__{tag}`` before the suffix for a variant that has a tag (JAX's
    name)."""
    tag = f"__{variant['tag']}" if variant and variant.get("tag") else ""
    return RESULTS_DIR / f"{arch_name}__{shape_name}__{mesh_kind}{tag}.json"


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, *, link_bw: float,
             force: bool = False, skip_calibration: bool = False,
             device: DeviceLike = "cuda", variant: Optional[dict] = None) -> dict:
    """Dry-run one cell on the fake production mesh under ``variant`` and
    write its record (or read the record a previous run wrote, unless
    ``force``)."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out_path = record_path(arch_name, shape_name, mesh_kind, variant)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    arch, shape = get_arch(arch_name), SHAPES[shape_name]
    dev = resolve_device(device)
    mesh = fake_production_mesh(multi_pod=(mesh_kind == "multi"), device=dev)
    record = dryrun_cell(arch, shape, mesh, mesh_kind=mesh_kind, link_bw=link_bw,
                         skip_calibration=skip_calibration, device=dev, variant=variant)
    out_path.write_text(json.dumps(record, indent=1))
    return record


def dryrun_cell(arch: ArchConfig, shape: ShapeConfig, mesh, *, mesh_kind: str, link_bw: float,
                skip_calibration: bool = False, device: DeviceLike = "cuda",
                variant: Optional[dict] = None) -> dict:
    """The record of one cell on ``mesh`` (a named DeviceMesh over an
    initialised, usually fake, default process group) under ``variant``
    (JAX's dict; the record keeps it).  A train cell takes
    ``MICROBATCHES``, any cell the variant's ``microbatches`` when it has
    them.  A production run that runs out of the card's memory gives a
    record that is not ``ok`` (:func:`_out_of_memory_record`)."""
    dev = resolve_device(device)
    mesh_shape = mesh_axis_sizes(mesh)
    chips = mesh.size()
    variant = dict(variant or {})
    mb = cell_microbatches(arch, shape, variant)
    rules = cell_rules(arch, mesh_shape, variant)
    rmesh = run_mesh(mesh, rules)

    # -- 1) production run: the coherence + memory proof ---------------------
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base_allocated = torch.cuda.memory_allocated(dev)
        _watch_out_of_memory()
    t0 = time.perf_counter()
    failed = None
    try:
        prod = _run_cell(arch, shape, mesh, rmesh, microbatches=mb, variant=variant, device=dev)
    except torch.OutOfMemoryError as e:
        failed = {"error": (str(e).splitlines() or [type(e).__name__])[0]}
        if dev.type == "cuda":
            failed.update(allocated_bytes=torch.cuda.memory_allocated(dev) - base_allocated,
                          peak_allocated_bytes=torch.cuda.max_memory_allocated(dev) - base_allocated,
                          **_LAST_OUT_OF_MEMORY)
            _LAST_OUT_OF_MEMORY.clear()
    if failed is not None:  # the failed run's tensors are freed once its traceback is
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return _out_of_memory_record(arch, shape, rules, mesh_kind=mesh_kind, chips=chips, mb=mb,
                                     link_bw=link_bw, variant=variant, dev=dev, failed=failed,
                                     seconds=time.perf_counter() - t0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_run = time.perf_counter() - t0
    memory = {"state_bytes": prod.state_bytes, "shard_bytes_allocated": prod.allocated_bytes}
    if dev.type == "cuda":
        memory["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev) - base_allocated
    prod_stats = prod.trace.stats()
    prod_per_axis = per_axis_collectives(prod.trace, prod.rmesh, mesh_shape)

    # -- 2) collective calibration: depths L0 < L1 ------------------------------
    t0 = time.perf_counter()
    calibration_failed = None
    if not skip_calibration:
        try:
            coll_stats, per_axis, coll_note = _calibrate(arch, shape, mesh, rmesh, mb, variant, dev, mesh_shape)
        except torch.OutOfMemoryError as e:
            calibration_failed = (str(e).splitlines() or [type(e).__name__])[0]
    if skip_calibration or calibration_failed:
        # the production run traced every layer at the cell's microbatches
        coll_stats = prod_stats
        per_axis = prod_per_axis
        coll_note = "production-run counts (every layer traced)"
        if calibration_failed:
            # a calibration run at 1 microbatch holds twice the rows of a
            # production microbatch at 2 or more, and may not fit where the
            # cell does
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            coll_note += f"; the calibration ran out of memory: {calibration_failed}"
    t_calib = time.perf_counter() - t0
    coll_bytes = roofline.total_collective_bytes(coll_stats)

    # -- 3) analytic compute/memory terms ---------------------------------------
    n_matmul = roofline.matmul_param_count(prod.params_shapes)
    cost = analytic.cell_cost(
        arch, shape, n_matmul,
        cache_bytes=prod.cache_bytes * chips,
        microbatches=mb,
    )

    report = roofline.RooflineReport(
        arch=arch.name,
        shape=shape.name,
        mesh=mesh_kind,
        chips=chips,
        hlo_flops=cost.flops_compiled / chips,
        hlo_bytes=cost.bytes_hbm / chips,
        collective_bytes=coll_bytes,
        collectives=coll_stats,
        model_flops=cost.flops_useful,
        link_bw=link_bw,
        bytes_per_device=prod.state_bytes,
        notes=f"microbatches={mb}; collectives: {coll_note}",
    )
    checks = _checks(prod, memory, dev)
    record = report.to_json()
    record.update(
        lower_seconds=round(t_run, 1),
        compile_seconds=round(t_calib, 1),
        memory_analysis=memory,
        flop_counter=prod.flops,
        production_collectives=prod_stats,
        production_per_axis_collectives=prod_per_axis,
        view_replications=prod.view_replications,
        param_gathers=prod.param_gathers,
        per_axis_collectives=per_axis,
        flops_breakdown=cost.breakdown,
        variant=variant,
        calibration_out_of_memory=calibration_failed,
        device=str(dev),
        card=card_info(),
        torch=torch.__version__,
        checks=checks,
        ok=not checks,
    )
    return record


# What the allocator's out-of-memory observer saw last: the request that
# failed and the bytes allocated on the device then.
_LAST_OUT_OF_MEMORY: Dict[str, int] = {}
_watching = False


def _watch_out_of_memory() -> None:
    """Have the CUDA allocator report its out-of-memory errors into
    ``_LAST_OUT_OF_MEMORY`` (once per process)."""
    global _watching
    if _watching:
        return

    def seen(device, alloc, device_alloc, device_free):
        _LAST_OUT_OF_MEMORY.update(request_bytes=int(alloc), device_allocated_bytes=int(device_alloc),
                                   device_free_bytes=int(device_free))

    torch._C._cuda_attach_out_of_memory_observer(seen)
    _watching = True


def _calibrate(arch, shape, mesh, rmesh, mb, variant, dev, mesh_shape):
    """(collective stats, per-axis collectives, note) of the cell at its
    full depth and ``mb`` microbatches from calibration runs.

    Collective bytes/counts are F(L, m) = a + b*L + c*m + d*L*m
    (per-layer-per-microbatch weight gathers, per-layer activation
    reductions, per-microbatch top-level terms, constants): four runs at
    (L0,1),(L1,1),(L0,2),(L1,2) determine the coefficients exactly;
    prefill/decode cells use the depth-only linear model (two runs)."""
    L0, L1, _, _ = _calib_depths(arch)
    mbs = (1, 2) if (shape.kind == "train" and mb > 1) else (1,)
    meas, ax_meas = {}, {}
    for m_i in mbs:
        for L in (L0, L1):
            sub = dataclasses.replace(arch, n_layers=L)
            run = _run_cell(sub, shape, mesh, rmesh, microbatches=m_i, variant=variant, device=dev)
            meas[(L, m_i)] = run.trace.stats()
            ax_meas[(L, m_i)] = per_axis_collectives(run.trace, run.rmesh, mesh_shape)
    Lf = arch.n_layers
    fit = lambda table, get: bilinear({k: get(v) for k, v in table.items()}, L0, L1, Lf, mb)
    coll_stats = {
        key: {field: fit(meas, lambda s, k=key, f=field: s[k][f]) for field in ("bytes", "count")}
        for key in meas[(L0, 1)]
    }
    axes = set().union(*ax_meas.values())
    per_axis = {
        ax: {field: fit(ax_meas, lambda s, a=ax, f=field: s.get(a, {}).get(f, 0.0))
             for field in ("bytes", "count")}
        for ax in sorted(axes)
    }
    return coll_stats, per_axis, f"bilinear calibration: depths {L0},{L1} x microbatches {list(mbs)}"


def _out_of_memory_record(arch, shape, rules, *, mesh_kind, chips, mb, link_bw, variant, dev, failed,
                          seconds) -> dict:
    """The record of a cell whose production run ran out of memory: what
    needs no run (the state bytes from the specs, the analytic terms), the
    failure, ``ok`` false and the collective figures null."""
    state_bytes, cache_bytes = cell_state_bytes(arch, shape, rules)
    params_shapes = build_model(arch).init_shapes()
    cost = analytic.cell_cost(arch, shape, roofline.matmul_param_count(params_shapes),
                              cache_bytes=cache_bytes * chips, microbatches=mb)
    report = roofline.RooflineReport(
        arch=arch.name, shape=shape.name, mesh=mesh_kind, chips=chips,
        hlo_flops=cost.flops_compiled / chips, hlo_bytes=cost.bytes_hbm / chips,
        collective_bytes=0.0, collectives={}, model_flops=cost.flops_useful, link_bw=link_bw,
        bytes_per_device=state_bytes, notes=f"microbatches={mb}; out of memory: no collectives traced",
    )
    record = report.to_json()
    for key in ("collective_bytes", "collectives", "collective_term", "bottleneck", "roofline_fraction"):
        record[key] = None
    record.update(
        lower_seconds=round(seconds, 1),
        compile_seconds=None,
        memory_analysis={"state_bytes": state_bytes, "shard_bytes_allocated": None, **failed},
        out_of_memory=failed,
        flop_counter=None,
        production_collectives=None,
        production_per_axis_collectives=None,
        view_replications=None,
        param_gathers=None,
        per_axis_collectives=None,
        flops_breakdown=cost.breakdown,
        variant=variant,
        device=str(dev),
        card=card_info(),
        torch=torch.__version__,
        checks=[f"out of memory: {failed['error']}"],
        ok=False,
    )
    return record


def _checks(prod: CellRun, memory: Dict[str, float], dev: torch.device) -> List[str]:
    """The cell's failed checks: the state bytes of the local shards built
    equal the specs' (JAX's sharded state), and on the card the peak
    allocated bytes fit its memory."""
    failed = []
    if prod.allocated_bytes != prod.state_bytes:
        failed.append(f"local shards built hold {prod.allocated_bytes:.0f} B, the specs {prod.state_bytes:.0f} B")
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        if not memory["peak_allocated_bytes"] < total:
            failed.append(f"peak allocated {memory['peak_allocated_bytes']} B does not fit the card's {total} B")
    return failed


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--part", default="1/1", metavar="I/N",
                    help="with --all: every N-th arch x shape pair from the I-th (the matrix in pieces)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-calibration", action="store_true")
    ap.add_argument("--link-bw", type=float, required=True,
                    help="bytes per second of one link, the collective term's rate")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--variant", type=json.loads, default=None, metavar="JSON",
                    help="a variant dict, as tools/perf_hillclimb.py gives run_cell one")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if len(meshes) > 1 or args.all:
        # one fake process group per process: each mesh size in a child
        jobs = [(name, shape) for name, arch in sorted(all_archs().items()) for shape in cells(arch)] \
            if args.all else [(args.arch, args.shape)]
        i, n = (int(x) for x in args.part.split("/"))
        jobs = jobs[i - 1::n]
        return _fan_out(args, jobs, meshes)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    if args.variant is not None and not isinstance(args.variant, dict):
        ap.error("--variant must be a JSON object")
    tag = f"{args.arch} x {args.shape} x {meshes[0]}"
    try:
        rec = run_cell(
            args.arch, args.shape, meshes[0], link_bw=args.link_bw,
            force=args.force, skip_calibration=args.skip_calibration,
            device=args.device, variant=args.variant,
        )
    except Exception as e:  # the CLI's boundary: report the cell, exit non-zero
        traceback.print_exc()
        print(f"[FAIL] {tag}: {e}", flush=True)
        return 1
    peak = rec["memory_analysis"].get("peak_allocated_bytes")
    coll = "-" if rec["collective_bytes"] is None else f"{rec['collective_bytes']:.3e}"
    print(
        f"[{'OK' if rec['ok'] else 'FAIL'}] {tag}: flops/dev={rec['hlo_flops']:.3e} "
        f"bytes/dev={rec['hlo_bytes']:.3e} coll={coll} "
        f"bottleneck={rec['bottleneck']} state_bytes={rec['bytes_per_device']:.0f} "
        f"peak_allocated={peak} (run {rec['lower_seconds']}s, calibration {rec['compile_seconds']}s)"
        + "".join(f"; {c}" for c in rec["checks"]),
        flush=True,
    )
    return 0 if rec["ok"] else 1


def _fan_out(args, jobs, meshes) -> int:
    """Run each (arch, shape, mesh) cell in a child process of this CLI
    (a process holds one fake process group), write the child's wall time
    into its record (``child_seconds``), and report the failures."""
    import sys

    failures = []
    for arch_name, shape_name in jobs:
        for m in meshes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_name,
                   "--shape", shape_name, "--mesh", m, "--link-bw", repr(args.link_bw),
                   "--device", args.device]
            cmd += ["--force"] if args.force else []
            cmd += ["--skip-calibration"] if args.skip_calibration else []
            cmd += ["--variant", json.dumps(args.variant)] if args.variant is not None else []
            t0, started = time.perf_counter(), time.time()
            rc = subprocess.run(cmd).returncode
            wall = round(time.perf_counter() - t0, 1)
            print(f"[child] {arch_name} x {shape_name} x {m}: exit {rc} after {wall} s", flush=True)
            path = record_path(arch_name, shape_name, m, args.variant)
            if path.exists() and path.stat().st_mtime >= started:  # this child's record
                rec = json.loads(path.read_text())
                path.write_text(json.dumps({**rec, "child_seconds": wall}, indent=1))
            if rc != 0:
                failures.append(f"{arch_name} x {shape_name} x {m}")
    if failures:
        print(f"{len(failures)} dry-run cells failed: {failures}", flush=True)
        return 1
    print(f"all {len(jobs) * len(meshes)} dry-run cells ran OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
