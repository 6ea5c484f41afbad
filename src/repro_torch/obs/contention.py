"""Per-link contention attribution and the avoidable-contention gauge
(port of ``repro.obs.contention``).

The paper's argument is that contention is *avoidable*: a partition's
communication time is pinned by its bisection, and the isoperimetry
engine certifies how far any granted geometry sits above the best
achievable one.  This module turns that into a report over a live
:class:`~repro_torch.network.allocation.MachineState` (or any explicit
per-job traffic decomposition):

* **per-link attribution** — each live job's all-to-all load field,
  split into *self* traffic (links whose both endpoints are the job's own
  cells) and *cross* traffic (links it loads through foreign territory:
  the spill corridors of :func:`repro_torch.network.placement.is_spilling`);
* **hotspot links** — the most loaded links of the summed background,
  each broken down by owning job;
* **avoidable contention** — per partition, the pairing load of its
  granted geometry against that of the certified-optimal geometry from
  :func:`repro_torch.network.isoperimetry.advise_partition`.

The fields, their sum, the own-link masks, the self/cross split and the
hotspot ranking run on ``device`` (the machine's, for
:func:`attribute_contention`).  A machine's fields are its exact int64
accumulators' terms, so the split and the sums are exact there.  Hotspot
ties (equal loads) are broken toward the lowest flat link index, a rule
the JAX package leaves to ``np.argpartition``.

>>> from repro_torch.network.allocation import MachineState
>>> m = MachineState((4, 4, 4), device="cpu")
>>> _ = m.allocate(0, (2, 2, 2))
>>> rep = attribute_contention(m)
>>> [j.job_id for j in rep.jobs], rep.jobs[0].avoidable_ratio
([0], 1.0)
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.trace import count_dispatch

__all__ = [
    "ContentionReport",
    "HotspotLink",
    "JobContention",
    "attribute_contention",
    "attribute_traffic",
    "render_dashboard",
]


@dataclass(frozen=True)
class JobContention:
    """Attribution record for one live partition."""

    job_id: int
    units: int
    geometry: Tuple[int, ...]
    oriented: Tuple[int, ...]
    offset: Tuple[int, ...]
    self_load: float  # job traffic on links internal to its own cells
    cross_load: float  # job traffic routed through foreign territory
    max_link_load: float  # measured peak of the job's own field
    pairing_load: float  # pairing-benchmark peak of the granted geometry
    optimal_geometry: Optional[Tuple[int, ...]]  # advisor's certified best
    optimal_max_load: float  # pairing peak of the optimal geometry
    bound: float  # Theorem 3.1 floor on the optimal bisection cut
    avoidable_ratio: float  # pairing time current/optimal (>= 1.0)
    certified: bool  # optimum pinned analytically by the bound

    @property
    def avoidable_excess(self) -> float:
        """Avoidable fraction of the job's communication time: 0.0 when
        the granted geometry is isoperimetrically optimal, ~1.0 when the
        paper's worst geometry doubles it."""
        return self.avoidable_ratio - 1.0


@dataclass(frozen=True)
class HotspotLink:
    """One heavily loaded directed link with its per-job load shares (on
    HyperX, ``direction`` is the clique link's destination coordinate)."""

    dim: int
    direction: int
    cell: Tuple[int, ...]
    load: float
    shares: Dict[int, float]  # job_id -> load contribution


@dataclass(frozen=True)
class ContentionReport:
    """Machine-wide contention attribution snapshot."""

    dims: Tuple[int, ...]
    jobs: Tuple[JobContention, ...]
    hotspots: Tuple[HotspotLink, ...]
    total_load: float  # summed background volume over all links
    max_link_load: float  # peak of the summed background
    cross_load: float = 0.0  # summed cross traffic over all jobs

    def to_dict(self) -> Dict[str, Any]:
        """Machine-readable JSON form of the report."""
        return {
            "dims": list(self.dims),
            "total_load": self.total_load,
            "max_link_load": self.max_link_load,
            "cross_load": self.cross_load,
            "jobs": [
                {
                    "job_id": j.job_id,
                    "units": j.units,
                    "geometry": list(j.geometry),
                    "oriented": list(j.oriented),
                    "offset": list(j.offset),
                    "self_load": j.self_load,
                    "cross_load": j.cross_load,
                    "max_link_load": j.max_link_load,
                    "pairing_load": j.pairing_load,
                    "optimal_geometry": None if j.optimal_geometry is None else list(j.optimal_geometry),
                    "optimal_max_load": j.optimal_max_load,
                    "theorem31_bound": j.bound,
                    "avoidable_ratio": j.avoidable_ratio,
                    "avoidable_excess": j.avoidable_excess,
                    "certified": j.certified,
                }
                for j in self.jobs
            ],
            "hotspots": [
                {
                    "dim": h.dim,
                    "direction": h.direction,
                    "cell": list(h.cell),
                    "load": h.load,
                    "shares": {str(k): v for k, v in sorted(h.shares.items())},
                }
                for h in self.hotspots
            ],
        }

    def to_json(self, path: Optional[str] = None) -> str:
        """Serialise :meth:`to_dict`; also write to ``path`` when given."""
        text = json.dumps(self.to_dict(), indent=1)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
        return text


def _own_link_mask(dims: Tuple[int, ...], oriented: Sequence[int], offset: Sequence[int],
                   device: DeviceLike = "cuda") -> torch.Tensor:
    """(D, 2, *dims) bool on ``device``: links whose both endpoints are the
    job's cells (the cell mask rolled one step along each dimension)."""
    from repro_torch.network.placement import cells_index

    dev = resolve_device(device)
    dims = tuple(int(a) for a in dims)
    cells = torch.zeros(dims, dtype=torch.bool, device=dev)
    cells[cells_index(dims, tuple(oriented), tuple(offset), dev)] = True
    mask = torch.zeros((len(dims), 2) + dims, dtype=torch.bool, device=dev)
    for k in range(len(dims)):
        fwd = cells & torch.roll(cells, -1, dims=k)  # link cell -> cell+1
        mask[k, 0] = fwd
        mask[k, 1] = torch.roll(fwd, 1, dims=k)  # link cell -> cell-1
    return mask


_NO_ADVICE = (None, 0.0, 0.0, 0.0, 1.0, False)


def _advise(dims_or_fabric, units: int, geometry: Tuple[int, ...], unit_node_dims: Optional[Sequence[int]],
            device: DeviceLike) -> Tuple[Optional[Tuple[int, ...]], float, float, float, float, bool]:
    """(optimal_geometry, pairing_load, optimal_load, bound, ratio,
    certified) for one partition, from the port's advisor on ``device``.
    On a HyperX fabric the contention benchmark is the box's all-to-all
    (pairing never contends across diameter-1 dimensions)."""
    from repro_torch.network.fabric import HyperXFabric
    from repro_torch.network.isoperimetry import advise_partition, scaled_node_dims
    from repro_torch.network.routing import hyperx_all_to_all_max_load, predict_pairing_time

    try:
        advice = advise_partition(dims_or_fabric, units, geometry, unit_node_dims=unit_node_dims, device=device)
    except ValueError:
        return _NO_ADVICE
    if isinstance(dims_or_fabric, HyperXFabric):
        cur_load = hyperx_all_to_all_max_load(dims_or_fabric.sub_fabric(geometry))
        opt_load = hyperx_all_to_all_max_load(dims_or_fabric.sub_fabric(advice.optimal_geometry))
    else:
        cur_load = predict_pairing_time(scaled_node_dims(geometry, unit_node_dims), 1.0, 1.0).max_link_load
        opt_load = predict_pairing_time(scaled_node_dims(advice.optimal_geometry, unit_node_dims), 1.0, 1.0).max_link_load
    return (
        tuple(advice.optimal_geometry),
        float(cur_load),
        float(opt_load),
        float(advice.bound),
        float(advice.predicted_speedup),
        bool(advice.certified),
    )


def _hotspot_order(total: torch.Tensor, top: int) -> torch.Tensor:
    """Flat indices of the ``top`` most loaded links of ``total`` (1-D),
    loads descending, equal loads toward the lowest index; only links
    carrying load count."""
    k = min(max(int(top), 0), int((total > 0.0).sum()))
    if k <= 0:
        return total.new_zeros(0, dtype=torch.int64)
    order = torch.sort(-total, stable=True).indices
    return order[:k]


def _attribute(
    dims: Tuple[int, ...],
    link_shape: Tuple[int, ...],
    fields: Dict[int, torch.Tensor],
    scales: Dict[int, float],
    placements: Dict[int, Any],
    own_mask,
    advise_target,
    unit_node_dims: Optional[Sequence[int]],
    top_hotspots: int,
    decode,
    dev: torch.device,
) -> ContentionReport:
    """The report from per-job fields on ``dev`` (``loads = field /
    scale``; an int64 field with its scale gives exact self/cross sums).
    ``own_mask(p)`` is a placement's own-link mask in the fields' layout,
    ``decode(i)`` a flat link index's (dim, direction, cell)."""
    count_dispatch("attribute_contention", dev.type)
    total = torch.zeros(link_shape, dtype=torch.float64, device=dev)
    per_job: List[torch.Tensor] = []
    loads_of: Dict[int, torch.Tensor] = {}
    meta = []
    advice_memo: Dict[Tuple[int, Tuple[int, ...]], tuple] = {}
    for jid in sorted(fields):
        # A device tensor, not a Python number: CUDA divides by a host
        # scalar as a multiplication by its reciprocal, which rounds
        # differently from the CPU's division.
        field, scale = fields[jid], torch.tensor(scales[jid], dtype=torch.float64, device=dev)
        loads = field.to(torch.float64) / scale
        loads_of[jid] = loads
        total += loads
        p = placements.get(jid)
        if p is not None:
            own = own_mask(p)
            parts = torch.stack([field[own].sum(), field[~own].sum()]).to(torch.float64) / scale
            geometry = tuple(int(g) for g in p.geometry)
            units = math.prod(int(w) for w in p.oriented)
            key = (units, geometry)
            if key not in advice_memo:
                advice_memo[key] = _advise(advise_target, units, geometry, unit_node_dims, dev)
            meta.append((jid, p, units, advice_memo[key]))
        else:
            parts = torch.stack([loads.sum(), loads.new_zeros(())])
            meta.append((jid, None, 0, _NO_ADVICE))
        peak = loads.max() if loads.numel() else loads.new_zeros(())
        per_job.append(torch.cat([parts, peak.reshape(1)]))
    flat = total.reshape(-1)
    idx = _hotspot_order(flat, top_hotspots)
    jids = sorted(fields)
    shares = torch.stack([loads_of[j].reshape(-1)[idx] for j in jids]) if jids else flat.new_zeros((0, idx.shape[0]))
    summary = torch.stack([flat.sum(), flat.max() if flat.numel() else flat.new_zeros(())])
    host = [t.cpu().numpy() for t in (torch.stack(per_job) if per_job else flat.new_zeros((0, 3)),
                                       idx, flat[idx], shares, summary)]
    job_parts, idx_h, hot_loads, share_h, (total_load, peak_total) = host
    jobs: List[JobContention] = []
    cross_total = 0.0
    for (jid, p, units, adv), (self_load, cross_load, peak) in zip(meta, job_parts):
        opt_geom, cur_load, opt_load, bound, ratio, certified = adv
        cross_total += float(cross_load)
        jobs.append(
            JobContention(
                job_id=int(jid),
                units=units,
                geometry=() if p is None else tuple(int(g) for g in p.geometry),
                oriented=() if p is None else tuple(int(w) for w in p.oriented),
                offset=() if p is None else tuple(int(o) for o in p.offset),
                self_load=float(self_load),
                cross_load=float(cross_load),
                max_link_load=float(peak),
                pairing_load=cur_load,
                optimal_geometry=opt_geom,
                optimal_max_load=opt_load,
                bound=bound,
                avoidable_ratio=ratio,
                certified=certified,
            )
        )
    hotspots = []
    for col, i in enumerate(idx_h):
        kdim, direction, cell = decode(int(i))
        hotspots.append(
            HotspotLink(
                dim=int(kdim),
                direction=int(direction),
                cell=tuple(int(c) for c in cell),
                load=float(hot_loads[col]),
                shares={int(j): float(share_h[r, col]) for r, j in enumerate(jids) if share_h[r, col] > 0.0},
            )
        )
    return ContentionReport(
        dims=dims,
        jobs=tuple(jobs),
        hotspots=tuple(hotspots),
        total_load=float(total_load),
        max_link_load=float(peak_total),
        cross_load=cross_total,
    )


def _as_tensor(loads, dev: torch.device) -> torch.Tensor:
    if isinstance(loads, torch.Tensor):
        return loads.to(dev)
    return torch.from_numpy(np.array(loads, dtype=np.float64)).to(dev)


def _hyperx_parts(fabric, dev: torch.device):
    """The own-link mask function and the slot decoder of a HyperX fabric's
    dense link layout."""
    from repro_torch.network.placement import cells_index

    dims = fabric.dims
    n = math.prod(dims)
    table = fabric.links()
    link = torch.from_numpy(table.link).to(dev)
    src = torch.from_numpy(table.src).to(dev)
    dst = torch.from_numpy(table.dst).to(dev)
    bases = np.cumsum([0] + [n * a for a in dims])[:-1]

    def own_mask(p) -> torch.Tensor:
        member = torch.zeros(dims, dtype=torch.bool, device=dev)
        member[cells_index(dims, tuple(p.oriented), tuple(p.offset), dev)] = True
        member = member.reshape(-1)
        own = torch.zeros(table.n_slots, dtype=torch.bool, device=dev)
        own[link[member[src] & member[dst]]] = True
        return own

    def decode(i: int):
        kdim = max(d for d in range(len(dims)) if bases[d] <= i)
        rel = i - int(bases[kdim])
        return kdim, rel % dims[kdim], np.unravel_index(rel // dims[kdim], dims)

    return table.n_slots, own_mask, decode


def attribute_traffic(
    dims: Sequence[int],
    loads_by_job: Dict[int, Any],
    placements: Optional[Dict[int, Any]] = None,
    *,
    fabric=None,
    unit_node_dims: Optional[Sequence[int]] = None,
    top_hotspots: int = 5,
    device: DeviceLike = "cuda",
) -> ContentionReport:
    """Build a :class:`ContentionReport` from explicit per-job load tensors
    (each ``(D, 2, *dims)``, NumPy or torch) on ``device``.

    ``placements`` optionally maps job ids to
    :class:`~repro_torch.network.allocation.Placement` records; with them
    the self/cross split and the avoidable-contention gauge are computed,
    without them the report is attribution-only (geometry fields empty).
    A :class:`~repro_torch.network.fabric.HyperXFabric` as ``fabric``
    switches to flat per-slot load vectors in the fabric's dense link
    layout (``dims`` is then the fabric's own)."""
    dev = resolve_device(device)
    fields = {jid: _as_tensor(v, dev) for jid, v in loads_by_job.items()}
    return _attribute_fields(dims, fields, {jid: 1.0 for jid in fields}, placements or {}, fabric=fabric,
                             unit_node_dims=unit_node_dims, top_hotspots=top_hotspots, dev=dev)


def _attribute_fields(dims, fields, scales, placements, *, fabric, unit_node_dims, top_hotspots, dev):
    from repro_torch.network.fabric import HyperXFabric

    if isinstance(fabric, HyperXFabric):
        n_slots, own_mask, decode = _hyperx_parts(fabric, dev)
        for jid, f in fields.items():
            if tuple(f.shape) != (n_slots,):
                raise ValueError(
                    f"job {jid} loads must have shape ({n_slots},) for H{fabric.dims}; got {tuple(f.shape)}"
                )
        return _attribute(fabric.dims, (n_slots,), fields, scales, placements, own_mask, fabric, None,
                          top_hotspots, decode, dev)
    dims = tuple(int(a) for a in dims)
    shape = (len(dims), 2) + dims
    for jid, f in fields.items():
        if tuple(f.shape) != shape:
            raise ValueError(f"job {jid} loads must have shape {shape}; got {tuple(f.shape)}")

    def own_mask(p) -> torch.Tensor:
        return _own_link_mask(dims, p.oriented, p.offset, dev)

    def decode(i: int):
        kdim, direction, *cell = np.unravel_index(i, shape)
        return kdim, direction, cell

    return _attribute(dims, shape, fields, scales, placements, own_mask, dims, unit_node_dims,
                      top_hotspots, decode, dev)


def attribute_contention(
    machine,
    *,
    unit_node_dims: Optional[Sequence[int]] = None,
    top_hotspots: int = 5,
) -> ContentionReport:
    """Decompose a live :class:`~repro_torch.network.allocation.MachineState`
    into per-link load by owning job, with the avoidable-contention gauge
    per partition, on the machine's device.

    Each job's field is its all-to-all contention model, the machine's own
    integer-scaled field (:func:`repro_torch.network.placement.int_field`,
    ``2 n`` x :func:`~repro_torch.network.placement.placement_loads`), so
    the per-job fields sum to ``machine.traffic_loads()`` and the
    self/cross split is an int64 sum.  On a HyperX machine each box's
    all-to-all is routed minimally
    (:func:`repro_torch.network.routing.route_hyperx`); its cross traffic
    is structurally zero, since minimal paths never leave the box."""
    from repro_torch.network.fabric import HyperXFabric
    from repro_torch.network.placement import placement_cells

    dev = machine.device
    dims = tuple(int(a) for a in machine.dims)
    placements = dict(machine.placements)
    if isinstance(getattr(machine, "fabric", None), HyperXFabric):
        from repro_torch.network.routing import route_hyperx

        fabric = machine.fabric
        fields = {}
        for jid, p in placements.items():
            member = np.zeros(dims, dtype=bool)
            member[placement_cells(dims, p.oriented, p.offset)] = True
            cells = np.stack(np.nonzero(member), axis=1)
            t = cells.shape[0]
            si = np.repeat(np.arange(t), t)
            di = np.tile(np.arange(t), t)
            keep = si != di
            fields[jid] = _as_tensor(route_hyperx(fabric, cells[si[keep]], cells[di[keep]], 1.0, device=dev), dev)
        return _attribute_fields(dims, fields, {jid: 1.0 for jid in fields}, placements, fabric=fabric,
                                 unit_node_dims=None, top_hotspots=top_hotspots, dev=dev)
    fields = {jid: machine._field(p.oriented, p.offset) for jid, p in placements.items()}
    scales = {jid: 2.0 * math.prod(int(w) for w in p.oriented) for jid, p in placements.items()}
    return _attribute_fields(dims, fields, scales, placements, fabric=None, unit_node_dims=unit_node_dims,
                             top_hotspots=top_hotspots, dev=dev)


def render_dashboard(report: ContentionReport, width: int = 30) -> str:
    """Text dashboard of a :class:`ContentionReport`: per-partition
    avoidable-contention gauges (with a bar over ``avoidable_excess``)
    and the hotspot-link breakdown."""
    lines = [
        f"contention report — machine {report.dims}",
        f"  total link load {report.total_load:.3f}, "
        f"peak {report.max_link_load:.3f}, "
        f"cross traffic {report.cross_load:.3f}",
        "",
        f"{'job':>5} {'units':>6} {'geometry':>14} {'pairing':>8} {'opt':>8} "
        f"{'avoid x':>8} {'cert':>5}  avoidable",
    ]
    max_excess = max((j.avoidable_excess for j in report.jobs), default=0.0)
    scale = max(max_excess, 1.0)
    for j in report.jobs:
        bar = "#" * int(round(width * j.avoidable_excess / scale))
        geom = "x".join(str(g) for g in j.geometry) if j.geometry else "-"
        lines.append(
            f"{j.job_id:>5} {j.units:>6} {geom:>14} {j.pairing_load:>8.3f} "
            f"{j.optimal_max_load:>8.3f} {j.avoidable_ratio:>8.2f} "
            f"{'yes' if j.certified else 'no':>5}  {bar}"
        )
    if report.hotspots:
        lines.append("")
        lines.append("hotspot links (dim, dir, cell -> load; shares by job):")
        for h in report.hotspots:
            shares = ", ".join(f"{jid}:{load:.3f}" for jid, load in sorted(h.shares.items()))
            lines.append(
                f"  d{h.dim}{'+' if h.direction == 0 else '-'} {h.cell} "
                f"-> {h.load:.3f}  [{shares}]"
            )
    return "\n".join(lines)
