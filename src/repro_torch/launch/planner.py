"""Fleet planner: joint geometry x mapping x sharding search per model (port
of the torus branches of ``repro.launch.planner``).

For one (config, chip budget) pair on a torus pod the planner jointly
searches

* **partition geometry** — every admissible cuboid, bisection-ranked by
  :func:`repro_torch.network.fabric.ranked_slice_geometries` (slice
  semantics: wrap links only where a slice spans a full pod dimension) or
  :func:`repro_torch.network.isoperimetry.ranked_geometries` (every
  partition its own fully-wrapped torus, the paper's Blue Gene/Q setting);
* **sharding rule** — PartitionSpec-style rule sets over the
  ``(data, fsdp, tensor, expert)`` logical axes, enumerated from the
  divisor lattice of the budget and validated by
  :func:`repro_torch.distributed.sharding.validate_partition_spec`;
* **rank mapping** — :func:`repro_torch.network.mapping.map_ranks` over the
  rule's own rank-space traffic, its strategy catalogue scored in one
  batched call on ``device``,

and prices every (geometry, rule, mapping) triple with ring-collective
times from ``assign_axes(mapping=)``'s measured embeddings, a
bisection-stress term priced as the paper's pairing benchmark on the
node-level dims (:func:`repro_torch.network.routing.predict_pairing_time`),
and roofline compute and memory terms from
:func:`repro_torch.analysis.analytic.cell_cost` over the H100 profile
(:mod:`repro_torch.analysis.h100`, read by name at call time).

Every price is a Python float computed in the JAX planner's order, and the
device work (geometry tables, mapping scores, drains) is exact, so rows
ranked by ``(step_time, geometry rank, axis sizes)`` are bit-equal to the
JAX planner's when the profile holds the same constants, on the card and
on the CPU alike.

A :class:`~repro_torch.network.fabric.HyperXFabric` pod plans over its
aligned sub-boxes (each a Hamming graph, ranked by the Lindsey-exact
bisection table), prices ring schedules on the wrapped-torus equivalent
of each box and the pairing term as one contention-free exchange over a
trunked clique link.

Differences from the JAX planner: ``pod`` is a required keyword (there is
no default pod); ``device`` replaces ``backend``; the rule validator
always runs.

>>> from repro_torch.network.fabric import TorusFabric
>>> plan = plan_model("mixtral-8x7b", 8, pod=TorusFabric.tpu((4, 4), link_bw=2e9),
...                   shape="decode_32k", device="cpu")
>>> plan.geometry, plan.best.axis_sizes  # (data, fsdp, tensor, expert)
((4, 2), (1, 1, 8, 1))
"""

from __future__ import annotations

import argparse
import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.analysis import h100
from repro_torch.analysis.analytic import BF16, cell_cost
from repro_torch.configs import SHAPES, ArchConfig, ShapeConfig, all_archs, get_arch
from repro_torch.core import bgq
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import validate_partition_spec
from repro_torch.network.collectives import (
    AxisAssignment,
    CollectiveCostModel,
    assign_axes,
)
from repro_torch.network.fabric import (
    HyperXFabric,
    TorusFabric,
    ranked_slice_geometries,
    slice_fabric,
)
from repro_torch.network.geometry import Geometry, canonical, volume
from repro_torch.network.isoperimetry import ranked_geometries, scaled_node_dims
from repro_torch.network.mapping import RankMapping, map_ranks
from repro_torch.network.netsim import simulate_fabric_traffic, simulate_traffic
from repro_torch.network.routing import predict_pairing_time
from repro_torch.obs import TRACER as _TRACER

__all__ = [
    "AXES",
    "BGQ_PODS",
    "ORDER_HINT",
    "PlanCandidate",
    "ShardingRuleSet",
    "SlicePlan",
    "add_plan_arguments",
    "bgq_pod",
    "default_chip_budget",
    "enumerate_rules",
    "format_table",
    "pairing_stress_volume",
    "plan_fleet",
    "plan_from_args",
    "plan_model",
    "price_candidate",
    "rule_rank_traffic",
    "rule_traffic",
]

#: Logical mesh axes of every candidate sharding rule, in the row-major
#: rank-ravel order used for the mapping (insertion order of
#: ``assign_axes``'s ``axis_sizes`` dict).
AXES: Tuple[str, ...] = ("data", "fsdp", "tensor", "expert")

#: Axis priority for the physical assignment: heaviest collective pressure
#: first (per-layer tensor exchanges > expert all-to-all > parameter
#: gather/scatter > once-per-step gradient reduce).
ORDER_HINT: Tuple[str, ...] = ("tensor", "expert", "fsdp", "data")


# ---------------------------------------------------------------------------
# Sharding rules.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardingRuleSet:
    """One candidate sharding of a config over the ``AXES`` logical mesh.

    ``axis_sizes`` is ``(data, fsdp, tensor, expert)`` parallelism degrees
    (product == chip budget); ``specs`` are the explicit PartitionSpec-style
    rules (name, per-dimension entries) the rule set stands for.
    """

    axis_sizes: Tuple[int, int, int, int]
    specs: Tuple[Tuple[str, Tuple], ...]

    @property
    def mesh_shape(self) -> Dict[str, int]:
        """Logical axis sizes as the ``assign_axes`` dict (AXES order)."""
        return dict(zip(AXES, self.axis_sizes))

    @property
    def order_hint(self) -> List[str]:
        """The physical-assignment priority (:data:`ORDER_HINT`)."""
        return list(ORDER_HINT)


def _rule_specs(axis_sizes: Tuple[int, int, int, int], moe: bool):
    """Explicit PartitionSpec-style rules of one parallelism split; size-1
    axes are dropped (a trivial axis shards nothing)."""
    d, f, t, e = axis_sizes
    D = "data" if d > 1 else None
    F = "fsdp" if f > 1 else None
    T = "tensor" if t > 1 else None
    E = "expert" if e > 1 else None
    batch = tuple(a for a in (D, F) if a is not None)
    specs = [
        ("embed", (T, F)),
        ("attn.wq", (F, T, None)),
        ("attn.wo", (T, None, F)),
        ("batch", (batch if batch else None, None)),
    ]
    if moe:
        specs.append(("moe.wi", (E, F, T)))
        specs.append(("moe.wo", (E, T, F)))
    else:
        specs.append(("mlp.wi", (F, T)))
        specs.append(("mlp.wo", (T, F)))
    return tuple(specs)


def _validate_specs(rule: ShardingRuleSet) -> None:
    """Check every spec of the rule against the ``AXES`` mesh."""
    for _name, spec in rule.specs:
        validate_partition_spec(spec, AXES)


def _divisors(n: int) -> List[int]:
    return [k for k in range(1, n + 1) if n % k == 0]


def enumerate_rules(cfg: ArchConfig, chips: int) -> List[ShardingRuleSet]:
    """All candidate ``(data, fsdp, tensor, expert)`` splits of a budget.

    ``tensor`` must divide the head count, ``expert`` the expert count (1
    for non-MoE configs), and ``data``/``fsdp`` absorb the rest.  Splits
    whose per-chip weight residency ``2 * params / (tensor * expert *
    fsdp)`` exceeds ``h100.HBM_BYTES`` are filtered out; if nothing
    survives the filter is waived, so the planner still ranks the
    least-bad rules.  Order: ascending ``tensor``, then ``expert``, then
    ``fsdp``.
    """
    n_experts = cfg.moe.num_experts if cfg.moe is not None else 1
    param_bytes = float(BF16) * cfg.param_count()
    rules: List[ShardingRuleSet] = []
    for t in _divisors(chips):
        if cfg.n_heads % t != 0:
            continue
        for e in _divisors(chips // t):
            if n_experts % e != 0:
                continue
            rest = chips // (t * e)
            for f in _divisors(rest):
                d = rest // f
                rules.append(
                    ShardingRuleSet((d, f, t, e), _rule_specs((d, f, t, e), cfg.moe is not None))
                )
    feasible = [
        r for r in rules
        if param_bytes / (r.axis_sizes[1] * r.axis_sizes[2] * r.axis_sizes[3]) <= h100.HBM_BYTES
    ]
    chosen = feasible if feasible else rules
    for r in chosen:
        _validate_specs(r)
    return chosen


# ---------------------------------------------------------------------------
# Traffic model: per-axis collective volumes of one (config, shape, rule).
# ---------------------------------------------------------------------------
def rule_traffic(
    cfg: ArchConfig, shape: ShapeConfig, axis_sizes: Tuple[int, int, int, int]
) -> List[Tuple[str, str, float]]:
    """Per-chip collective bytes of one step, as ``(axis, collective, bytes)``.

    Closed forms (bf16 activations and parameters):

    * ``tensor``: per-layer activation all-gather + reduce-scatter pairs
      (2 exchanges a layer; x3 in training for forward, backward and remat);
    * ``expert``: token dispatch/combine all-to-all (top-k x capacity
      tokens, 2 exchanges a layer at inference, 4 in training);
    * ``fsdp``: ZeRO-3 parameter all-gather (+ gradient reduce-scatter and
      the backward re-gather in training) of the ``1/(tensor*expert)``
      weight shard;
    * ``data``: the once-per-step gradient all-reduce of the fsdp-sharded
      gradient (training only).

    The entry order (tensor, expert, fsdp, data) is the pricing order.
    """
    d, f, t, e = axis_sizes
    L = cfg.n_layers
    B, S = shape.global_batch, shape.seq_len
    params = float(cfg.param_count())
    p_shard = BF16 * params / (t * e)
    tokens = float(B * S) if shape.kind in ("train", "prefill") else float(B)
    tokens_local = tokens / (d * f)
    act = tokens_local * cfg.d_model * BF16
    entries: List[Tuple[str, str, float]] = []
    if t > 1:
        mult = 3.0 if shape.kind == "train" else 1.0
        entries.append(("tensor", "all-gather", 2.0 * L * mult * act))
        entries.append(("tensor", "reduce-scatter", 2.0 * L * mult * act))
    if e > 1 and cfg.moe is not None:
        n_exchanges = 4.0 if shape.kind == "train" else 2.0
        a2a = (
            n_exchanges * L * tokens_local * cfg.moe.top_k
            * cfg.moe.capacity_factor * cfg.d_model * BF16
        )
        entries.append(("expert", "all-to-all", a2a))
    if f > 1:
        if shape.kind == "train":
            entries.append(("fsdp", "all-gather", 2.0 * p_shard))
            entries.append(("fsdp", "reduce-scatter", p_shard))
        else:
            entries.append(("fsdp", "all-gather", p_shard))
    if d > 1 and shape.kind == "train":
        entries.append(("data", "all-reduce", p_shard / f))
    return entries


def pairing_stress_volume(
    entries: Sequence[Tuple[str, str, float]],
    axis_sizes: Tuple[int, int, int, int],
) -> float:
    """Per-chip bytes of the geometry-sensitive (bisection-crossing) share:
    half the gradient all-reduce's bytes (its first halving-doubling
    exchange) and the ``1/e`` slice-spanning share of the expert
    all-to-all, priced as the paper's pairing benchmark."""
    _, _, _, e = axis_sizes
    vol = 0.0
    for axis, collective, v in entries:
        if axis == "data" and collective == "all-reduce":
            vol += 0.5 * v
        if axis == "expert" and collective == "all-to-all":
            vol += v / e
    return vol


def rule_rank_traffic(
    axis_sizes: Tuple[int, int, int, int],
    entries: Sequence[Tuple[str, str, float]],
    pair_volume: float,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Rank-space ``(src, dst, vol)`` messages of a rule's collectives.

    Ring collectives become bidirectional nearest-neighbour exchanges on
    their logical axis (half the axis volume each way), the expert
    all-to-all all-pairs messages within each expert group, and the
    pairing stress pairs each rank with its data-axis antipode.  Message
    order is deterministic (AXES order, +1 before -1, ascending all-to-all
    offset, pairing last).  ``None`` when the rule moves no bytes.
    """
    shape = tuple(axis_sizes)
    n = int(np.prod(shape))
    per_axis: Dict[str, float] = {a: 0.0 for a in AXES}
    a2a_volume = 0.0
    for axis, collective, v in entries:
        if axis == "expert" and collective == "all-to-all":
            a2a_volume += v
        else:
            per_axis[axis] += v
    ranks = np.arange(n, dtype=np.int64)
    coords = np.stack(np.unravel_index(ranks, shape), axis=1)
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    vols: List[np.ndarray] = []

    def _send(dst_coords: np.ndarray, v: float) -> None:
        dst = np.ravel_multi_index(tuple(dst_coords.T), shape)
        srcs.append(ranks)
        dsts.append(dst.astype(np.int64))
        vols.append(np.full(n, v, dtype=np.float64))

    for k, axis in enumerate(AXES):
        s, v = shape[k], per_axis[axis]
        if s <= 1 or v <= 0.0:
            continue
        for step in (1, -1):
            nb = coords.copy()
            nb[:, k] = (nb[:, k] + step) % s
            _send(nb, v / 2.0)
    e = shape[3]
    if e > 1 and a2a_volume > 0.0:
        for off in range(1, e):
            nb = coords.copy()
            nb[:, 3] = (nb[:, 3] + off) % e
            _send(nb, a2a_volume / e)
    d = shape[0]
    if d > 1 and pair_volume > 0.0:
        nb = coords.copy()
        nb[:, 0] = (nb[:, 0] + d // 2) % d
        _send(nb, pair_volume)
    if not srcs:
        return None
    return np.concatenate(srcs), np.concatenate(dsts), np.concatenate(vols)


# ---------------------------------------------------------------------------
# Candidate pricing.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PlanCandidate:
    """One priced (geometry, mapping, sharding rule) triple."""

    geometry: Geometry
    geometry_rank: int  # index in the bisection-ranked geometry list
    bisection_links: int
    bisection_efficiency: float  # this geometry's bisection / best rankable
    fabric: Union[TorusFabric, HyperXFabric]
    rule: ShardingRuleSet
    mapping: Optional[RankMapping]
    assignment: AxisAssignment
    traffic: Tuple[Tuple[str, str, float], ...]
    pair_volume_node: float  # node-level pairing-stress bytes
    node_dims: Geometry  # dims the pairing term is priced on
    ring_time: float
    pairing_time: float
    compute_time: float
    memory_time: float
    simulated_slowdown: float = 1.0

    @property
    def axis_sizes(self) -> Tuple[int, int, int, int]:
        """The rule's ``(data, fsdp, tensor, expert)`` degrees."""
        return self.rule.axis_sizes

    @property
    def comm_time(self) -> float:
        """Total predicted communication seconds per step."""
        return self.ring_time + self.pairing_time

    @property
    def step_time(self) -> float:
        """Roofline step time: overlapped compute/memory + exposed comm."""
        return max(self.compute_time, self.memory_time) + self.comm_time

    @property
    def mapping_strategy(self) -> str:
        """The winning mapping strategy (``"none"`` for a silent rule)."""
        return self.mapping.strategy if self.mapping is not None else "none"

    def row(self) -> Tuple:
        """Comparable scalar row (what the parity tests compare)."""
        return (
            self.geometry,
            self.axis_sizes,
            self.mapping_strategy,
            self.ring_time,
            self.pairing_time,
            self.compute_time,
            self.memory_time,
            self.step_time,
        )

    def sort_key(self) -> Tuple:
        """Exact deterministic ranking key: predicted step time, then the
        geometry's bisection rank, then axis sizes."""
        return (self.step_time, self.geometry_rank, self.axis_sizes)


def _decode_cache_bytes(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Whole-fleet KV-cache bytes for decode shapes (attention archs)."""
    if shape.kind != "decode" or cfg.is_attention_free:
        return 0.0
    return (
        2.0 * cfg.n_layers * shape.global_batch * shape.seq_len
        * cfg.n_kv_heads * cfg.resolved_head_dim * BF16
    )


Priced = Tuple[Optional[RankMapping], AxisAssignment, Tuple, float, float, float, float, float]


def price_candidate(
    cfg: ArchConfig,
    shape: ShapeConfig,
    fabric: Union[TorusFabric, HyperXFabric],
    node_dims: Geometry,
    n_compute: int,
    rule: ShardingRuleSet,
    device: DeviceLike = "cuda",
) -> Optional[Priced]:
    """Price one (fabric, rule) pair; None when the rule cannot embed.

    * ring time: ``assign_axes(fabric, mesh_shape, ORDER_HINT, mapping=)``
      then :data:`~repro_torch.network.collectives.COLLECTIVE_TIME` per
      traffic entry, summed in entry order;
    * pairing time: the node-level stress volume times
      ``predict_pairing_time(node_dims).time_per_volume`` (on a HyperX box,
      one contention-free stage over the longest dimension's trunked
      link);
    * compute and memory time: :func:`cell_cost` over the H100 profile.

    With tracing on (:data:`repro_torch.obs.TRACER`) each pricing records a
    ``planner.price`` span with the fabric's dims, the rule's axis sizes
    and whether the rule embedded.
    """
    if not _TRACER.enabled:
        return _price_candidate_impl(cfg, shape, fabric, node_dims, n_compute, rule, device)
    with _TRACER.span(
        "planner.price", fabric=tuple(fabric.dims), rule=tuple(rule.axis_sizes)
    ) as sp:
        priced = _price_candidate_impl(cfg, shape, fabric, node_dims, n_compute, rule, device)
        sp.annotate(embedded=priced is not None)
        return priced


def _ring_equivalent(fabric: HyperXFabric) -> TorusFabric:
    """Wrapped-torus stand-in for pricing ring schedules on a HyperX box.

    A ring pass along one dimension of a clique uses one direct link per
    hop stage, like a fully-wrapped torus dimension, so ring-collective
    times on ``H(S)`` equal those on the wrapped torus of the same dims
    with per-link bandwidth ``K_k * link_bw`` (exact for uniform trunking;
    the minimum multiplicity keeps it conservative otherwise), and single
    links on length-2 dimensions: the trunking is already in the rate."""
    bw = fabric.link_bw * min(fabric.link_multiplicity)
    return TorusFabric(fabric.dims, (True,) * len(fabric.dims), bw, double_link_on_2=False)


def _price_candidate_impl(
    cfg: ArchConfig,
    shape: ShapeConfig,
    fabric: Union[TorusFabric, HyperXFabric],
    node_dims: Geometry,
    n_compute: int,
    rule: ShardingRuleSet,
    device: DeviceLike,
) -> Optional[Priced]:
    chips = fabric.num_chips
    hyperx = isinstance(fabric, HyperXFabric)
    ring_fab = _ring_equivalent(fabric) if hyperx else fabric
    entries = rule_traffic(cfg, shape, rule.axis_sizes)
    pair_chip = pairing_stress_volume(entries, rule.axis_sizes)
    traffic = rule_rank_traffic(rule.axis_sizes, entries, pair_chip)
    mapping = None
    try:
        if traffic is not None:
            mapping = map_ranks(
                ring_fab.dims,
                ring_fab.dims,
                logical_dims=tuple(rule.axis_sizes),
                traffic=traffic,
                double_link_on_2=ring_fab.double_link_on_2,
                refine=False,  # the catalogue alone: refinement is a seeded local search
                wrap=ring_fab.wrap,
                device=device,
            )
        assignment = assign_axes(ring_fab, rule.mesh_shape, order_hint=rule.order_hint, mapping=mapping)
    except ValueError:
        return None  # rule does not embed in this geometry
    cost_model = CollectiveCostModel(ring_fab, assignment)
    ring_time = 0.0
    for axis, collective, vol in entries:
        ring_time += cost_model.time(collective, axis, vol)
    # Node-level pairing stress: per-chip volume rescaled to the node torus
    # (identity on chip-level fabrics where volume(node_dims) == chips).
    pair_node = pair_chip * chips / volume(node_dims)
    pairing_time = 0.0
    if pair_node > 0.0 and hyperx:
        # Halving-doubling partners differ in one coordinate of the split
        # dimension, so every pair has its own direct clique link: the
        # exchange drains in one contention-free stage over a K_k-trunked
        # link.
        sides = fabric.dims
        if max(sides) > 1:
            k = max(range(len(sides)), key=lambda i: sides[i])
            pairing_time = pair_node / (fabric.link_bw * fabric.link_multiplicity[k])
    elif pair_node > 0.0:
        pred = predict_pairing_time(
            node_dims, 1.0, fabric.link_bw, double_link_on_2=fabric.double_link_on_2
        )
        pairing_time = pair_node * pred.time_per_volume
    cost = cell_cost(
        cfg, shape, float(cfg.param_count()), cache_bytes=_decode_cache_bytes(cfg, shape)
    )
    compute_time = cost.flops_compiled / (n_compute * h100.PEAK_FLOPS)
    memory_time = cost.bytes_hbm / (n_compute * h100.HBM_BW)
    return (
        mapping, assignment, tuple(entries), pair_node,
        ring_time, pairing_time, compute_time, memory_time,
    )


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SlicePlan:
    """The planner's answer for one (config, chip budget): a ranked table
    of priced (geometry, mapping, rule) triples, best first."""

    arch: str
    shape: str
    chips: int
    pod_dims: Geometry
    wrap_mode: str
    table: Tuple[PlanCandidate, ...]

    @property
    def best(self) -> PlanCandidate:
        """The top-ranked row."""
        return self.table[0]

    @property
    def geometry(self) -> Geometry:
        """The best row's geometry."""
        return self.best.geometry

    @property
    def step_time(self) -> float:
        """The best row's step time (seconds)."""
        return self.best.step_time

    @property
    def bisection_efficiency(self) -> float:
        """The best row's bisection over the best rankable geometry's."""
        return self.best.bisection_efficiency

    @property
    def simulated_slowdown(self) -> float:
        """The best row's flow-simulated contention multiplier."""
        return self.best.simulated_slowdown

    def geometry_preferences(self) -> List[Geometry]:
        """Distinct geometries in ranked-row order (for occupancy walks)."""
        seen, out = set(), []
        for cand in self.table:
            if cand.geometry not in seen:
                seen.add(cand.geometry)
                out.append(cand.geometry)
        return out

    def to_request(self, job_id: int, duration: float = 1.0, arrival: float = 0.0):
        """The plan as a scheduler
        :class:`repro_torch.network.allocation.JobRequest` carrying the
        planner-chosen geometry."""
        from repro_torch.network.allocation import JobRequest

        return JobRequest(
            job_id=job_id,
            units=self.chips,
            duration=duration,
            arrival=arrival,
            geometry=self.geometry,
        )


def default_chip_budget(cfg: ArchConfig) -> int:
    """Smallest power-of-two budget whose ZeRO-3 bf16 weight shards fit
    ``h100.HBM_BYTES`` (at least 4; optimizer and cache headroom is the
    caller's concern)."""
    need = BF16 * cfg.param_count() / h100.HBM_BYTES
    return max(4, 2 ** math.ceil(math.log2(max(need, 1.0))))


def _require_pod(pod) -> None:
    if not isinstance(pod, (TorusFabric, HyperXFabric)):
        raise TypeError(f"pod must be a repro_torch TorusFabric or HyperXFabric, got {type(pod).__name__}")


def plan_model(
    arch: Union[str, ArchConfig],
    chips: Optional[int] = None,
    *,
    pod: Union[TorusFabric, HyperXFabric],
    shape: Union[str, ShapeConfig] = "decode_32k",
    wrap_mode: str = "slice",
    unit_node_dims: Optional[Sequence[int]] = None,
    simulate_top_k: int = 0,
    device: DeviceLike = "cuda",
) -> SlicePlan:
    """Jointly search geometry x mapping x sharding for one config on
    ``pod`` (required).

    ``wrap_mode="slice"`` (default): geometries from
    :func:`ranked_slice_geometries`, wrap links only where a slice spans a
    full pod dimension.  ``wrap_mode="torus"``: the paper's Blue Gene/Q
    semantics, every partition its own fully-wrapped torus
    (:func:`ranked_geometries`), with ``unit_node_dims`` scaling allocation
    units to the node level.  ``chips`` defaults to
    :func:`default_chip_budget`, capped at the pod's size.

    ``simulate_top_k`` drains the top-k rows' mapped traffic through the
    flow simulator on ``device`` and records the measured contention
    multiplier on ``simulated_slowdown`` (1.0 otherwise).

    On a :class:`HyperXFabric` pod the slice/torus distinction collapses
    (an aligned sub-box of a clique dimension is itself a clique), so both
    ``wrap_mode`` values rank the same bisection table
    (:func:`ranked_geometries` on the fabric); ``unit_node_dims`` is
    rejected there.
    """
    _require_pod(pod)
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    shape_cfg = shape if isinstance(shape, ShapeConfig) else SHAPES[shape]
    budget = chips if chips is not None else min(default_chip_budget(cfg), pod.num_chips)
    if isinstance(pod, HyperXFabric):
        if wrap_mode not in ("slice", "torus"):
            raise ValueError(f"wrap_mode must be 'slice' or 'torus', got {wrap_mode!r}")
        if unit_node_dims is not None:
            raise ValueError(
                "unit_node_dims is the BG/Q torus node-scaling convention; "
                "HyperX pods plan over allocation-unit boxes directly"
            )
        ranked = ranked_geometries(pod, budget, device=device)
        fabrics = [(g, bis, pod.sub_fabric(g)) for g, bis in ranked]
        nodes = [fab.dims for _, _, fab in fabrics]
    elif wrap_mode == "slice":
        ranked = ranked_slice_geometries(pod, budget, device=device)
        fabrics = [(g, bis, slice_fabric(pod, g)) for g, bis in ranked]
        nodes = [fab.dims for _, _, fab in fabrics]
    elif wrap_mode == "torus":
        ranked = ranked_geometries(pod.dims, budget, unit_node_dims, device=device)
        fabrics = [
            (g, bis, TorusFabric(g, (True,) * len(g), pod.link_bw,
                                 double_link_on_2=pod.double_link_on_2))
            for g, bis in ranked
        ]
        nodes = [scaled_node_dims(g, unit_node_dims) for g, _ in ranked]
    else:
        raise ValueError(f"wrap_mode must be 'slice' or 'torus', got {wrap_mode!r}")
    best_bis = ranked[0][1]
    rules = enumerate_rules(cfg, budget)
    rows: List[PlanCandidate] = []
    for gi, ((geom, bis, fabric), node_dims) in enumerate(zip(fabrics, nodes)):
        n_compute = volume(node_dims)
        for rule in rules:
            priced = price_candidate(cfg, shape_cfg, fabric, node_dims, n_compute, rule, device=device)
            if priced is None:
                continue
            mapping, assignment, entries, pair_node, ring, pairing, compute, memory = priced
            rows.append(
                PlanCandidate(
                    geometry=canonical(geom),
                    geometry_rank=gi,
                    bisection_links=int(bis),
                    bisection_efficiency=(bis / best_bis if best_bis else 1.0),
                    fabric=fabric,
                    rule=rule,
                    mapping=mapping,
                    assignment=assignment,
                    traffic=entries,
                    pair_volume_node=pair_node,
                    node_dims=canonical(node_dims),
                    ring_time=ring,
                    pairing_time=pairing,
                    compute_time=compute,
                    memory_time=memory,
                )
            )
    if not rows:
        raise ValueError(
            f"no (geometry, rule) candidate of {budget} chips embeds in pod "
            f"{pod.dims} for arch {cfg.name}"
        )
    rows.sort(key=PlanCandidate.sort_key)
    if simulate_top_k > 0:
        simulated = [
            replace(cand, simulated_slowdown=_simulate(cand, device))
            for cand in rows[:simulate_top_k]
        ]
        rows = simulated + rows[simulate_top_k:]
    return SlicePlan(
        arch=cfg.name,
        shape=shape_cfg.name,
        chips=budget,
        pod_dims=canonical(pod.dims),
        wrap_mode=wrap_mode,
        table=tuple(rows),
    )


def _simulate(cand: PlanCandidate, device: DeviceLike) -> float:
    """Flow-simulated contention multiplier of one row's mapped traffic,
    floored at 1 (on doubled size-2 dims a contention-free pattern beats
    the single-link zero-contention bound)."""
    if cand.mapping is None:
        return 1.0
    src, dst, vol = cand.mapping.machine_traffic()
    if len(vol) == 0 or float(np.sum(vol)) <= 0.0:
        return 1.0
    if isinstance(cand.fabric, HyperXFabric):
        sim = simulate_fabric_traffic(cand.fabric, (src, dst, vol), link_bw=cand.fabric.link_bw, device=device)
        return max(1.0, float(sim.slowdown))
    sim = simulate_traffic(
        cand.fabric.dims, (src, dst, vol),
        link_bw=cand.fabric.link_bw,
        double_link_on_2=cand.fabric.double_link_on_2,
        device=device,
    )
    return max(1.0, float(sim.slowdown))


def format_table(plan: SlicePlan, top: int = 8) -> str:
    """Human-readable ranked table of a plan."""
    head = (
        f"{plan.arch} · {plan.shape} · {plan.chips} chips on pod "
        f"{plan.pod_dims} ({plan.wrap_mode})"
    )
    cols = (
        f"{'geometry':>12} {'d,f,t,e':>12} {'mapping':>16} {'comm(ms)':>9} "
        f"{'step(ms)':>9} {'bis.eff':>8} {'slowdown':>9}"
    )
    lines = [head, cols]
    for cand in plan.table[:top]:
        lines.append(
            f"{str(cand.geometry):>12} {str(cand.axis_sizes):>12} "
            f"{cand.mapping_strategy:>16} {cand.comm_time * 1e3:>9.3f} "
            f"{cand.step_time * 1e3:>9.3f} {cand.bisection_efficiency:>8.2f} "
            f"{cand.simulated_slowdown:>9.3f}"
        )
    if len(plan.table) > top:
        lines.append(f"... {len(plan.table) - top} more rows")
    return "\n".join(lines)


def plan_fleet(
    archs: Optional[Sequence[Union[str, ArchConfig]]] = None,
    *,
    pod: Union[TorusFabric, HyperXFabric],
    **kwargs,
) -> List[SlicePlan]:
    """One :class:`SlicePlan` per config on ``pod`` (default: every
    registered arch, name-sorted), each at its :func:`default_chip_budget`
    unless ``chips`` is passed through ``kwargs``."""
    if archs is None:
        archs = sorted(all_archs())
    return [plan_model(a, pod=pod, **kwargs) for a in archs]


# ---------------------------------------------------------------------------
# The launchers' --plan-chips.
# ---------------------------------------------------------------------------
#: The paper's machines as planner pods, by ``--plan-pod`` name.
BGQ_PODS = {"mira": bgq.MIRA, "juqueen": bgq.JUQUEEN, "sequoia": bgq.SEQUOIA}


def bgq_pod(name: str) -> TorusFabric:
    """A Blue Gene/Q machine's midplane torus as a pod: double links on
    length-2 dimensions at ``bgq.LINK_BANDWIDTH_GB_S`` per link, to be
    planned with ``wrap_mode="torus"`` and
    ``unit_node_dims=bgq.MIDPLANE_DIMS`` (the paper's setting)."""
    return TorusFabric.bgq(BGQ_PODS[name].midplane_dims, link_bw=bgq.LINK_BANDWIDTH_GB_S * 1e9)


def add_plan_arguments(ap: argparse.ArgumentParser, default_shape: str) -> None:
    """The launchers' planner flags: ``--plan-chips``, ``--plan-shape`` and
    ``--plan-pod`` (required with ``--plan-chips``: the port has no
    default pod)."""
    ap.add_argument(
        "--plan-chips", type=int, default=None,
        help="print the fleet planner's ranked plan for this arch at the given "
             "budget of midplanes of --plan-pod, then exit (no model is built)",
    )
    ap.add_argument("--plan-shape", default=default_shape, choices=sorted(SHAPES))
    ap.add_argument("--plan-pod", default=None, choices=sorted(BGQ_PODS),
                    help="the Blue Gene/Q machine --plan-chips plans on (torus mode, 2 GB/s links)")


def plan_from_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> SlicePlan:
    """Plan ``args.arch`` at ``args.plan_chips`` midplanes of
    ``args.plan_pod`` on ``args.device``, draining the top row, print the
    ranked table and return the plan."""
    if args.plan_pod is None:
        ap.error("--plan-chips needs --plan-pod (one of " + ", ".join(sorted(BGQ_PODS)) + ")")
    plan = plan_model(
        args.arch, args.plan_chips, pod=bgq_pod(args.plan_pod), shape=args.plan_shape,
        wrap_mode="torus", unit_node_dims=bgq.MIDPLANE_DIMS, simulate_top_k=1,
        device=args.device,
    )
    print(format_table(plan))
    return plan
