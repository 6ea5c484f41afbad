"""Three-term roofline of a step (port of ``repro.analysis.roofline``).

    compute term    = FLOPs / (chips * PEAK_FLOPS)
    memory term     = HBM bytes / (chips * HBM_BW)
    collective term = collective_bytes / (chips * link_bw)

The FLOPs and bytes are per device (the dry-run takes them from the
analytic model, :mod:`repro_torch.analysis.analytic`), so the chips cancel;
the normalisation is kept explicit as in JAX.  The compute and memory rates
are the H100 profile's (:mod:`repro_torch.analysis.h100`), read when a term
is computed.  The link rate of the collective term has no default: it is
the rate of the fabric the caller prices.

Collective bytes come from :class:`CollectiveTrace`, a dispatch mode that
sees every functional collective (``torch.ops._c10d_functional``) that runs
under it, which is what DTensor runs when it redistributes, and the
point-to-point exchanges that :mod:`repro_torch.distributed.collective_matmul`
records into it.  Each is counted with its result bytes (JAX's proxy for
ring traffic: an n-rank ring all-gather moves (n-1)/n of them per link) and
its process group, under JAX's five type names.  :func:`flop_count` counts
a call's FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` (meta
tensors count); :class:`LocalFlopCounter` counts the FLOPs each rank's
shards take under DTensor with the same formulas.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch import tree
from repro_torch.analysis import h100

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# functional collectives by overload packet name -> JAX's type name
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass(frozen=True)
class CollectiveOp:
    """One traced collective: its type, result bytes and process group."""

    kind: str
    bytes: int
    group_name: str
    group_ranks: Tuple[int, ...]


def _group_ranks(group_name: str) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(group_name)))


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(out) if isinstance(t, torch.Tensor))


class CollectiveTrace(TorchDispatchMode):
    """Records every functional collective that runs while it is active.

    DTensor ops are passed on (``NotImplemented``), so the collectives that
    DTensor runs on the local shards come back through this mode and are
    counted.  ``ops`` lists them in order; :meth:`stats` sums them by type.
    """

    def __init__(self):
        super().__init__()
        self.ops: List[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            kind = _FUNCTIONAL.get(func._opname)
            if kind is not None:
                name = kwargs.get("group_name", args[-1])
                self.record(kind, _nbytes(out), name)
        return out

    def record(self, kind: str, nbytes: int, group_name: str) -> None:
        """Count one collective of ``kind`` (a JAX type name) with result
        bytes ``nbytes`` over the process group named ``group_name``."""
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective type {kind!r} (one of {COLLECTIVES})")
        self.ops.append(CollectiveOp(kind, int(nbytes), group_name, _group_ranks(group_name)))

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-collective-type {count, bytes}, JAX's ``collective_stats``."""
        out: Dict[str, Dict[str, float]] = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
        for op in self.ops:
            out[op.kind]["count"] += 1
            out[op.kind]["bytes"] += op.bytes
        return out


def active_traces() -> List[CollectiveTrace]:
    """The collective traces on the current dispatch-mode stack (code that
    communicates outside the functional collectives records into them)."""
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, CollectiveTrace)]


def total_collective_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return float(sum(v["bytes"] for v in stats.values()))


class LocalFlopCounter(TorchDispatchMode):
    """FLOPs of the ops that run on this process's tensors, by
    ``FlopCounterMode``'s formulas, while it is active.

    DTensor ops are passed on (``NotImplemented``), so the local ops they
    run on each shard are counted; ops on meta and fake tensors (DTensor's
    sharding propagation runs ops on them at global shapes) are not.
    """

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not any(
                t.is_meta or isinstance(t, FakeTensor) for t in tree.leaves(args) if isinstance(t, torch.Tensor)):
            name = str(func._overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0.0) + float(formula(*args, **kwargs, out_val=out))
        return out

    def counts(self) -> Dict[str, float]:
        """{"flops": total, op name: flops, ...}"""
        return {"flops": float(sum(self.by_op.values())), **self.by_op}


def flop_count(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict[str, float]]:
    """``fn(*args, **kwargs)`` under ``FlopCounterMode``: (its result,
    {"flops": total, op name: flops, ...}).  Meta tensors count without
    computing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    by_op = {str(op): float(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return out, {"flops": float(counter.get_total_flops()), **by_op}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: Dict[str, Dict[str, float]]
    # model-level accounting
    model_flops: float  # 6*N*D (dense) or 6*N_active*D per step, global
    # bytes per second of one link: the fabric's rate (no default)
    link_bw: float
    # memory accounting
    bytes_per_device: Optional[float] = None
    notes: str = ""

    # -- the three terms (seconds) ------------------------------------------------
    @property
    def compute_term(self) -> float:
        return self.hlo_flops * self.chips / (self.chips * h100.PEAK_FLOPS)

    @property
    def memory_term(self) -> float:
        return self.hlo_bytes * self.chips / (self.chips * h100.HBM_BW)

    @property
    def collective_term(self) -> float:
        return self.collective_bytes * self.chips / (self.chips * self.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_term,
            "memory": self.memory_term,
            "collective": self.collective_term,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.compute_term, self.memory_term, self.collective_term)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global FLOPs: how much computed work is useful."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful FLOPs over the bound-time's compute."""
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * h100.PEAK_FLOPS)

    def to_json(self) -> Dict[str, Any]:
        d = asdict(self)
        d.update(
            compute_term=self.compute_term,
            memory_term=self.memory_term,
            collective_term=self.collective_term,
            bottleneck=self.bottleneck,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def model_flops_per_step(
    n_params_matmul: float, tokens: float, moe_active_fraction: float = 1.0,
    training: bool = True,
) -> float:
    """6*N*D for training (fwd+bwd), 2*N*D for inference forward."""
    mult = 6.0 if training else 2.0
    return mult * n_params_matmul * moe_active_fraction * tokens


def matmul_param_count(params_shapes) -> float:
    """Parameters participating in matmuls (ndim >= 2 after stacking dims);
    the leaves may be meta tensors."""
    return float(sum(math.prod(t.shape) for t in tree.leaves(params_shapes) if t.dim() >= 2))
