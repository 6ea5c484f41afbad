"""Attribute traced collectives to logical mesh axes, and price them with
the paper's contention model (port of ``repro.analysis.axis_attribution``).

Every collective a :class:`~repro_torch.analysis.roofline.CollectiveTrace`
records carries its process group.  :func:`per_axis_collectives` names the
group by the mesh dimension it belongs to (``DeviceMesh.get_group(dim)``;
a dimension named ``"pod+data"`` is the flattened product of those axes),
and any other group by its members: for a row-major device mesh (pod,
data, model) the *minor* axis ("model") forms contiguous groups (stride 1),
"data" strides by |model| and "pod" by |data|*|model|, which
:func:`classify_axis` reads from (group size, stride).

The contention-aware collective term then prices each axis with its
physical embedding: a wrapped ring (2 directions x the link rate), a chain
(1x) or the cross-pod rate.  This is where the paper's geometry / assignment
analysis enters the roofline.  The link rate and the cross-pod rate are
arguments: the port states no fabric's numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.analysis.roofline import CollectiveTrace


def classify_axis(
    group_size: int, stride: int, mesh_shape: Dict[str, int]
) -> str:
    """Map (group size, stride) to a mesh axis (or axis product) name."""
    names = list(mesh_shape)
    # minor-to-major strides in a row-major mesh
    strides = {}
    acc = 1
    for n in reversed(names):
        strides[n] = acc
        acc *= mesh_shape[n]
    for n in names:
        if group_size == mesh_shape[n] and stride == strides[n]:
            return n
    # axis products (e.g. ("pod","data") fsdp groups)
    for i in range(len(names)):
        for j in range(i + 1, len(names) + 1):
            prod = 1
            for n in names[i:j]:
                prod *= mesh_shape[n]
            if group_size == prod and stride in (strides[names[j - 1]], 1):
                return "+".join(names[i:j])
    if group_size == acc:
        return "ALL"
    return f"unknown({group_size},{stride})"


def _group_signature(ranks: Tuple[int, ...]) -> Tuple[int, int]:
    """(group size, stride of its first two members), as JAX reads a
    replica group."""
    if len(ranks) < 2:
        return len(ranks), 1
    return len(ranks), ranks[1] - ranks[0]


def per_axis_collectives(
    trace: CollectiveTrace, mesh, mesh_shape: Optional[Dict[str, int]] = None
) -> Dict[str, Dict[str, float]]:
    """axis -> {bytes, count} summed over the traced collectives.

    ``mesh`` is the named ``DeviceMesh`` the traced code ran on; a group
    that is none of its dimensions' is classified by its members against
    ``mesh_shape`` (default: ``mesh``'s own axis sizes)."""
    names = list(mesh.mesh_dim_names)
    by_group = {mesh.get_group(i).group_name: n for i, n in enumerate(names)}
    if mesh_shape is None:
        mesh_shape = dict(zip(names, mesh.shape))
    out: Dict[str, Dict[str, float]] = {}
    for op in trace.ops:
        axis = by_group.get(op.group_name)
        if axis is None:
            axis = classify_axis(*_group_signature(op.group_ranks), mesh_shape)
        slot = out.setdefault(axis, {"bytes": 0.0, "count": 0})
        slot["bytes"] += op.bytes
        slot["count"] += 1
    return out


# ---------------------------------------------------------------------------
# Contention-aware pricing (the paper's model applied to the roofline)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AxisBandwidth:
    name: str
    effective_bw: float  # bytes/s available to one chip's collective stream
    why: str


def axis_bandwidths(
    mesh_shape: Dict[str, int], link_bw: float, cross_pod_bw: float,
    model_gets_best_rings: bool = True,
) -> Dict[str, AxisBandwidth]:
    """Physical bandwidth per logical axis under an assignment plan.

    Paper-faithful planning (``model_gets_best_rings=True``) gives the
    heavy-traffic "model" axis the wrapped contiguous rings (2 x
    ``link_bw``) and "data" the second dimension's rings (also wrapped on a
    full pod).  The naive plan (False) models an allocator that hands
    "model" a strided / chain embedding: half the effective bandwidth, the
    analogue of the paper's elongated-partition penalty.  "pod" crosses
    pods at ``cross_pod_bw``.
    """
    out = {}
    for name in mesh_shape:
        if name == "pod":
            out[name] = AxisBandwidth(name, cross_pod_bw, "cross-pod link")
        elif name == "model":
            bw = 2 * link_bw if model_gets_best_rings else link_bw
            out[name] = AxisBandwidth(
                name, bw, "wrapped ring" if model_gets_best_rings else "chain/strided embedding"
            )
        else:
            out[name] = AxisBandwidth(name, 2 * link_bw, "wrapped ring")
    return out


def contention_aware_collective_term(
    per_axis: Dict[str, Dict[str, float]],
    mesh_shape: Dict[str, int],
    link_bw: float,
    cross_pod_bw: float,
    model_gets_best_rings: bool = True,
) -> Tuple[float, Dict[str, float]]:
    """Seconds per step, per-device, pricing each axis with its embedding."""
    bws = axis_bandwidths(mesh_shape, link_bw, cross_pod_bw, model_gets_best_rings)
    per_axis_time = {}
    for axis, stat in per_axis.items():
        parts = axis.split("+")
        # an axis-product collective (fsdp groups) is bottlenecked by its
        # slowest member; 'ALL'/'unknown' get the conservative single link
        if axis == "ALL" or axis.startswith("unknown"):
            bw = link_bw
        else:
            bw = min(bws[p].effective_bw for p in parts if p in bws) if all(
                p in bws for p in parts
            ) else link_bw
        per_axis_time[axis] = stat["bytes"] / bw
    return sum(per_axis_time.values()), per_axis_time
