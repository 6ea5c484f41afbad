"""Paper-driven slice and mesh-axis planning (port of the NumPy half of
``repro.launch.mesh``).

1. **Slice geometry** (:func:`plan_slice`): when a job asks for C chips of
   a pod, the isoperimetric analysis picks the cuboid slice with maximal
   internal bisection; with an occupancy grid the placement search picks
   where it goes and :func:`~repro_torch.network.mapping.map_ranks` embeds
   the logical mesh on it; with ``arch=`` the fleet planner chooses the
   geometry and the logical axes.
2. **Axis assignment** (:func:`plan_axes`): logical mesh axes are mapped
   onto physical torus dimensions so that the heaviest-traffic axis gets
   the best rings; the resulting
   :class:`~repro_torch.network.collectives.CollectiveCostModel` prices
   every collective.

The pod is a required argument everywhere (the port has no default pod
and no default data-centre link rate).

The dry-run's device meshes: :func:`make_production_mesh` builds the
logical production mesh, (16, 16) ("data", "model") on one pod or
(2, 16, 16) ("pod", "data", "model") on two, as a ``DeviceMesh`` over the
initialised default process group; :func:`fake_production_mesh` first
initialises a fake process group of 256 or 512 ranks (this process is rank
0, and collectives move no data), the counterpart of JAX's
``--xla_force_host_platform_device_count=512``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network.allocation import MachineState, Placement
from repro_torch.network.collectives import AxisAssignment, CollectiveCostModel, assign_axes
from repro_torch.network.fabric import (
    TorusFabric,
    best_slice_geometry,
    ranked_slice_geometries,
    slice_fabric,
    worst_slice_geometry,
)
from repro_torch.network.mapping import RankMapping, map_ranks
from repro_torch.network.netsim import simulate_traffic
from repro_torch.network.placement import best_placement

__all__ = [
    "MeshPlan",
    "fake_production_mesh",
    "make_production_mesh",
    "multi_pod_cost_model",
    "plan_axes",
    "plan_slice",
    "production_mesh_shape",
]


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """Axis name -> size of the logical production mesh."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = "cuda"):
    """The production ``DeviceMesh`` on ``device``'s type, over the default
    process group (which must have 256 or 512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = production_mesh_shape(multi_pod)
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def fake_production_mesh(multi_pod: bool = False, device: DeviceLike = "cuda"):
    """:func:`make_production_mesh` on a fake process group of the mesh's
    size, initialised here as the default group with this process as rank
    0.  A default group that is already initialised must be a fake one of
    that size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    ranks = math.prod(production_mesh_shape(multi_pod).values())
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)
    elif dist.get_backend() != "fake" or dist.get_world_size() != ranks:
        raise RuntimeError(
            f"the default process group ({dist.get_backend()}, {dist.get_world_size()} ranks) "
            f"is not a fake group of {ranks} ranks"
        )
    return make_production_mesh(multi_pod=multi_pod, device=device)


@dataclass(frozen=True)
class MeshPlan:
    """The physical plan behind a logical mesh."""

    slice_geometry: Tuple[int, ...]
    slice_bisection_links: int
    worst_geometry: Tuple[int, ...]
    worst_bisection_links: int
    assignment: AxisAssignment
    cost_model: CollectiveCostModel
    placement: Optional[Placement] = None  # set by occupancy-aware planning
    mapping: Optional[RankMapping] = None  # rank->chip embedding (with placement)
    #: Flow-simulated contention multiplier of the mapping's traffic on the
    #: pod (None unless ``plan_slice(..., simulate=True)`` ran on an
    #: occupancy-aware plan).
    simulated_slowdown: Optional[float] = None
    #: The chosen geometry's internal bisection over the best rankable
    #: geometry of this size on an *empty* pod (< 1.0 when occupancy forced
    #: the planner down the ranked list).
    bisection_efficiency: float = 1.0
    #: The fleet planner's ranked table
    #: (:class:`repro_torch.launch.planner.SlicePlan`) when the plan was
    #: built with ``plan_slice(..., arch=...)``.
    slice_plan: Optional[object] = None

    @property
    def avoidable_contention(self) -> float:
        """Bisection ratio best/worst: the paper's avoidable-contention factor."""
        if self.worst_bisection_links == 0:
            return 1.0
        return self.slice_bisection_links / self.worst_bisection_links

    @property
    def predicted_contention(self) -> float:
        """Shared-link contention score of the planned placement (0 when the
        plan was geometry-only or the pod was empty)."""
        return self.placement.predicted_contention if self.placement else 0.0

    @property
    def mapping_congestion(self) -> float:
        """Predicted intra-job max link load of the chosen rank mapping
        under the mesh's ring-collective (halo) traffic; 0.0 for
        geometry-only plans."""
        return self.mapping.score.congestion if self.mapping else 0.0


def plan_slice(
    chips: int,
    pod: TorusFabric,
    state: Optional[MachineState] = None,
    job_id: Optional[int] = None,
    simulate: bool = False,
    arch: Optional[str] = None,
    shape: str = "decode_32k",
    device: DeviceLike = "cuda",
) -> MeshPlan:
    """Choose slice geometry + axis layout for a C-chip job on one pod.

    Without ``state`` the plan is geometry-only: the isoperimetric optimum
    among all cuboids of the requested size.  With a ``state`` (a
    :class:`MachineState` over the pod's chips) the planner walks
    geometries in slice-bisection order and takes the first one with a
    free translate, placed by the scored search on the state's device;
    ``job_id`` commits it to ``state``.  Occupancy-aware plans also carry
    a halo rank mapping of the logical mesh on the placed chips, whose
    measured stride and wrap price the collectives.

    ``simulate=True`` drains the chosen mapping's traffic through the flow
    simulator and records the contention multiplier (occupancy-aware
    plans only).  ``arch`` switches on planner-backed mode: the fleet
    planner (:func:`repro_torch.launch.planner.plan_model`) searches
    geometry x mapping x sharding for that config under ``shape``, the
    geometry walk follows its ranked table and the logical axes come from
    its winning rule.  Table scoring, mapping and drains run on
    ``device``.
    """
    slice_plan = None
    if arch is not None:
        from repro_torch.launch.planner import plan_model  # lazy: mesh <- planner cycle

        slice_plan = plan_model(arch, chips, pod=pod, shape=shape, device=device)
    placement: Optional[Placement] = None
    best_bis: Optional[int] = None
    if state is None:
        if job_id is not None:
            raise ValueError("job_id requires a state (occupancy grid) to commit to")
        if slice_plan is not None:
            geom = slice_plan.geometry
            bis = slice_fabric(pod, geom).bisection_links()
            best_bis = ranked_slice_geometries(pod, chips, device=device)[0][1]
        else:
            geom, bis = best_slice_geometry(pod, chips, device=device)
            best_bis = bis
    else:
        if tuple(state.dims) != tuple(pod.dims):
            raise ValueError(f"occupancy grid dims {state.dims} != pod dims {pod.dims}")
        geom = None
        bis = 0
        ranked = ranked_slice_geometries(pod, chips, device=device)
        best_bis = ranked[0][1]
        if slice_plan is not None:
            ranked = [
                (g, slice_fabric(pod, g).bisection_links())
                for g in slice_plan.geometry_preferences()
            ]
        for g, b in ranked:
            cand = best_placement(state.grid, g, state.traffic_loads_t(), device=state.device)
            if cand is not None:
                geom, bis = g, b
                placement = Placement(
                    job_id=-1 if job_id is None else job_id,
                    geometry=g,
                    oriented=cand.oriented,
                    offset=cand.offset,
                    bisection_links=b,
                    predicted_contention=cand.contention,
                )
                break
        if geom is None:
            raise ValueError(f"no {chips}-chip cuboid slice fits the current occupancy of {pod.dims}")
        if job_id is not None:
            placement = state.commit(
                job_id, geom, placement.oriented, placement.offset,
                placement.predicted_contention, bisection=bis,
            )
    wgeom, wbis = worst_slice_geometry(pod, chips)
    fabric = slice_fabric(pod, geom)
    # default logical axes for a single-pod job: data x model, sized by the
    # slice dims (largest dim -> data).
    dims = sorted(fabric.dims, reverse=True)
    axes = {"data": dims[0], "model": chips // dims[0]}
    order_hint = ["model", "data"]
    if slice_plan is not None:
        # Planner-backed: the winning sharding rule's non-trivial axes.
        from repro_torch.launch.planner import AXES, ORDER_HINT

        planned = {
            name: size
            for name, size in zip(AXES, slice_plan.best.axis_sizes)
            if size > 1
        }
        if planned and _axes_embed(fabric, planned):
            axes = planned
            order_hint = [a for a in ORDER_HINT if a in axes]
    mapping = None
    if placement is not None:
        mapping = map_ranks(
            pod.dims,
            placement.oriented,
            placement.offset,
            logical_dims=tuple(axes.values()),
            pattern="halo",
            double_link_on_2=pod.double_link_on_2,
            wrap=pod.wrap,
            device=device,
        )
    assignment = assign_axes(fabric, axes, order_hint=order_hint, mapping=mapping)
    simulated_slowdown = None
    if simulate and mapping is not None:
        sim = simulate_traffic(
            pod.dims,
            mapping.machine_traffic(),
            link_bw=pod.link_bw,
            double_link_on_2=pod.double_link_on_2,
            device=device,
        )
        simulated_slowdown = sim.slowdown
    return MeshPlan(
        slice_geometry=geom,
        slice_bisection_links=bis,
        worst_geometry=wgeom,
        worst_bisection_links=wbis,
        assignment=assignment,
        cost_model=CollectiveCostModel(fabric, assignment),
        placement=placement,
        mapping=mapping,
        simulated_slowdown=simulated_slowdown,
        bisection_efficiency=(bis / best_bis if best_bis else 1.0),
        slice_plan=slice_plan,
    )


def _axes_embed(fabric: TorusFabric, axes: Dict[str, int]) -> bool:
    """Whether every logical axis can occupy whole physical dims of the
    fabric (the constraint :func:`assign_axes` enforces)."""
    try:
        assign_axes(fabric, axes, order_hint=list(axes))
        return True
    except ValueError:
        return False


def plan_axes(
    axis_sizes: Dict[str, int],
    traffic_order: Optional[Tuple[str, ...]] = None,
    *,
    pod: TorusFabric,
) -> CollectiveCostModel:
    """Map logical axes onto the whole pod torus, heaviest traffic first
    (default order: ``"model"`` then ``"data"``, then the rest in
    insertion order), so the heaviest axis gets the wrapped contiguous
    rings."""
    order = tuple(traffic_order) if traffic_order else ("model", "data")
    order = tuple([a for a in order if a in axis_sizes]) + tuple(
        a for a in axis_sizes if a not in (traffic_order or ())
        and a not in (order if traffic_order else ())
    )
    # dedupe, preserving order
    seen, final = set(), []
    for a in order:
        if a in axis_sizes and a not in seen:
            seen.add(a)
            final.append(a)
    assignment = assign_axes(pod, axis_sizes, order_hint=final)
    return CollectiveCostModel(pod, assignment)


def multi_pod_cost_model(
    axis_sizes: Dict[str, int], *, pod: TorusFabric, dci_bw: float
) -> Dict[str, CollectiveCostModel]:
    """Per-pod model for every axis but ``"pod"`` (:func:`plan_axes` on
    ``pod``) and a model for the ``"pod"`` axis, which rides the
    data-centre interconnect: a chain (no wrap) at ``dci_bw`` bytes/s per
    chip-pair share."""
    ici_axes = {k: v for k, v in axis_sizes.items() if k != "pod"}
    ici = plan_axes(ici_axes, pod=pod)
    dci_fabric = TorusFabric((axis_sizes.get("pod", 1),), (False,), dci_bw)
    dci_assignment = assign_axes(dci_fabric, {"pod": axis_sizes.get("pod", 1)})
    return {"ici": ici, "dci": CollectiveCostModel(dci_fabric, dci_assignment)}
