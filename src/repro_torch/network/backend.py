"""The network engines' hot passes in torch (port of the ``xla`` backend of
``repro.network.backend``).

The JAX package runs these passes under ``jax.jit`` so that the planner,
scheduler and advisor can score thousands of candidates per call.  Here
they are eager torch in float64 and int64, on the card unless the caller
passes ``device="cpu"``, where the same code runs on the CPU:

=========================  ==================================================
:func:`route_loads`        the DOR difference-array link-load tensor
                           (``index_add_`` + ``cumsum``)
:func:`prepare_drain`      the link x flow incidence compacted to ELL on the
                           host; the index lists and capacities move to the
                           device once
:func:`drain`              max-min progressive filling
:func:`drain_timeline`     the same, recording each step's link utilization
:func:`drain_batch`        many volume lanes of one plan, run together
:func:`score_candidates`   congestion and dilation of B candidate mappings,
                           batched in chunks under a memory budget
:func:`contention_field`   the FFT cross-correlation over all load planes
                           (:func:`snapped_contention`: against an integer
                           load field, rounded to the exact integer)
:func:`cut_scores`         the closed-form cuboid cut in int64
                           (:func:`hamming_cut_scores`: an aligned box's
                           cut in a Hamming graph)
:func:`adaptive_links`     the minimal-adaptive torus router's decisions and
                           links over a frozen DOR field (``cumsum``
                           prefixes, gathers, ``argmin``)
:func:`hyperx_flows`       HyperX minimal and DAL routing (``index_add_``
                           fields, ``scatter_reduce`` bottlenecks)
=========================  ==================================================

Exactness.  Link loads are sums of integer volumes, halved at most once
by a split tie, so every partial sum is exact in float64 whatever the
order: the card's ``index_add_`` and ``cumsum`` sum in a nondeterministic
order and still give the NumPy engine's tensor exactly, for integer or
dyadic volumes (for others, to float64 summation order).  The drain's
arithmetic is elementwise or an order-free ``min``/count, so a lane's
completion times do not depend on the device nor on the other lanes.

What stays NumPy: DOR path building, tie expansion and the ELL compaction
(irregular ``np.unique``/argsort work), the divisor enumeration and the
group-by of :func:`repro_torch.network.isoperimetry.cut_table`, and
result packaging.  Eager torch compiles nothing per shape, so the JAX
package's power-of-two message padding and jit-compile counter have no
counterpart; ``repro_torch.obs.DISPATCHES`` counts the calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network.geometry import volume
from repro_torch.obs import count_dispatch

__all__ = [
    "DrainPlan",
    "SCORE_BUDGET_BYTES",
    "adaptive_links",
    "contention_field",
    "cut_scores",
    "drain",
    "drain_batch",
    "drain_timeline",
    "hamming_cut_scores",
    "hyperx_flows",
    "hyperx_loads",
    "prepare_drain",
    "route_loads",
    "score_candidates",
    "score_chunk",
    "snapped_contention",
]

_EPS = 1e-12

#: Progressive-filling iterations between two host-side convergence
#: checks.  Iterations after a lane converges change nothing in it, so the
#: choice trades masked work against host synchronisations, not results.
CHECK_EVERY = 4


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev``; on the CPU it may share ``a``'s memory, so callers
    clone what they write."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    return torch.from_numpy(a).to(dev)


def _strides(dims: Tuple[int, ...]) -> Tuple[int, ...]:
    """C-order strides of the vertex grid."""
    out, acc = [], 1
    for a in reversed(dims):
        out.append(acc)
        acc *= a
    return tuple(reversed(out))


def _flat(dims: Tuple[int, ...], coords: torch.Tensor) -> torch.Tensor:
    """C-order flat vertex index of (..., D) coordinates."""
    flat = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    for j, stride in enumerate(_strides(dims)):
        flat += coords[..., j] * stride
    return flat


# ---------------------------------------------------------------------------
# (1) DOR link loads.
# ---------------------------------------------------------------------------
def route_loads(
    dims: Sequence[int],
    src: np.ndarray,
    dst: np.ndarray,
    vol,
    split_ties: bool = True,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Per-directed-link loads of a message batch under DOR routing: the
    ``(D, 2, *dims)`` tensor of ``repro.network.routing.route_dor``
    (``loads[k, d, *v]`` is the volume on the link leaving vertex v in
    dimension k, direction d: 0 is +1, 1 is -1).

    Each message reduces to a cyclic segment per dimension; a difference
    array over (direction, ring, position) takes +v at the segment's start,
    -v at its end and +v at position 0 when it wraps, and one ``cumsum``
    recovers the loads.  Exact for integer or dyadic volumes (module
    docstring)."""
    dev = resolve_device(device)
    dims = tuple(int(a) for a in dims)
    D = len(dims)
    src = np.atleast_2d(np.asarray(src, dtype=np.int64))
    dst = np.atleast_2d(np.asarray(dst, dtype=np.int64))
    if src.shape != dst.shape or src.shape[1] != D:
        raise ValueError(f"src/dst must have shape (M, {D}); got {src.shape}/{dst.shape}")
    M = src.shape[0]
    vol = np.broadcast_to(np.asarray(vol, dtype=np.float64), (M,))
    if M == 0:
        return np.zeros((D, 2) + dims, dtype=np.float64)
    count_dispatch("route_loads", dev.type)
    s_t, d_t, v_t = _tensor(src, dev), _tensor(dst, dev), _tensor(vol, dev)
    return _route_loads(dims, s_t, d_t, v_t, bool(split_ties)).cpu().numpy()


def _ring_loads(
    dims: Tuple[int, ...],
    k: int,
    mixed: torch.Tensor,
    s: torch.Tensor,
    d: torch.Tensor,
    vol: torch.Tensor,
    split_ties: bool,
) -> torch.Tensor:
    """Dimension-k link loads of B lanes of M messages, (B, 2, *dims):
    direction 0 the '+' links.  ``mixed`` is each message's flat vertex
    index where dimension k starts under DOR (dims below k already routed:
    the destination's coordinates; dims from k on: the source's), ``s`` and
    ``d`` its source and destination coordinate in dimension k, all (B,
    M).  Messages that do not move in dimension k add nothing and are left
    out first.  Each cyclic segment takes +v at its start, -v at its end
    and +v at position 0 when it wraps, in a difference array summed along
    dimension k by one ``cumsum``."""
    a = dims[k]
    B, M = mixed.shape
    n = volume(dims)
    stride = _strides(dims)[k]
    delta = torch.remainder(d - s, a).reshape(-1)
    moving = torch.nonzero(delta).squeeze(1)
    delta = delta[moving]
    s = s.reshape(-1)[moving]
    vol = vol.reshape(-1)[moving]
    ring0 = mixed.reshape(-1)[moving] - s * stride + torch.div(moving, M, rounding_mode="floor") * (2 * n)
    rev = a - delta
    hops = torch.minimum(delta, rev)
    tie = delta * 2 == a
    fwd = delta <= rev  # ties route forward in the primary segment
    v1 = torch.where(tie, vol * (0.5 if split_ties else 1.0), vol)
    bstart = torch.remainder(s - hops + 1, a)
    start = torch.where(fwd, s, bstart)
    segments = [(start, v1, ring0 + (~fwd).long() * n)]  # the '-' plane follows the '+' one
    if split_ties and a % 2 == 0:
        # The backward half of each split tie; zero for every other
        # message, which adds nothing to the loads.
        segments.append((bstart, (vol * 0.5).masked_fill(~tie, 0.0), ring0 + n))
    out = torch.zeros(B * 2 * n, dtype=torch.float64, device=mixed.device)
    for st, v, b in segments:
        end = st + hops
        em = torch.where(end >= a, end - a, end)  # end mod a (end < 2a)
        out.index_add_(0, b + st * stride, v)
        out.index_add_(0, b + em * stride, (-v).masked_fill(em == 0, 0.0))
        wraps = torch.nonzero(end > a).squeeze(1)  # most segments do not wrap: leave them out
        out.index_add_(0, b[wraps], v[wraps])
    return torch.cumsum(out.view((B, 2) + dims), dim=2 + k).clamp_(min=0.0)


def _route_loads(
    dims: Tuple[int, ...], src: torch.Tensor, dst: torch.Tensor, vol: torch.Tensor, split_ties: bool
) -> torch.Tensor:
    """The ``(D, 2, *dims)`` load tensor of (M, D) messages, on their
    device; with a leading lane axis on ``src``/``dst``/``vol`` ((B, M,
    D) and (B, M)), one tensor per lane, ``(B, D, 2, *dims)``."""
    lanes = src.ndim == 3
    if not lanes:
        src, dst, vol = src[None], dst[None], vol[None]
    B = src.shape[0]
    loads = torch.zeros((B, len(dims), 2) + dims, dtype=torch.float64, device=src.device)
    mixed = _flat(dims, src)
    for k, (a, stride) in enumerate(zip(dims, _strides(dims))):
        s, d = src[..., k], dst[..., k]
        if a > 1:
            loads[:, k] = _ring_loads(dims, k, mixed, s, d, vol, split_ties)
        mixed = mixed + (d - s) * stride
    return loads if lanes else loads[0]


def max_load_t(dims: Tuple[int, ...], loads: torch.Tensor, double_link_on_2: bool = True) -> torch.Tensor:
    """``routing.max_link_load`` of a ``(D, 2, *dims)`` load tensor on its
    device, as a 0-d tensor (no host synchronisation); of ``(B, D, 2,
    *dims)`` lanes, a (B,) tensor."""
    lanes = loads.ndim == len(dims) + 3
    m = torch.zeros(loads.shape[0] if lanes else (), dtype=loads.dtype, device=loads.device)
    for k, a in enumerate(dims):
        if a == 1:
            continue
        scale = 0.5 if (a == 2 and double_link_on_2) else 1.0
        plane = loads[:, k].flatten(1).amax(dim=1) if lanes else loads[k].max()
        m = torch.maximum(m, scale * plane)
    return m


# ---------------------------------------------------------------------------
# (2) Max-min progressive filling over an ELL incidence.
# ---------------------------------------------------------------------------
@dataclass
class DrainPlan:
    """One routed scenario in drain form: the link x flow incidence
    compacted to ELL (fixed-width padded index lists).

    ``lf[l]`` lists the flows crossing used link ``l`` (padded with the
    dummy flow ``n_flows``); ``fl[f]`` the used links of flow ``f`` (padded
    with the dummy link ``n_links_used``).  ``lf``, ``fl`` and ``cap`` live
    on ``device``; ``links`` maps each used link back to its id in the
    full layout of ``n_slots`` links (``(D, 2, *dims)`` flattened, or a
    fabric's dense slots).  ``vol`` is the scenario's own subflow volumes;
    :func:`drain` and :func:`drain_batch` take others with the same flow
    order, so one plan serves every translate of a translation-invariant
    scenario family.
    """

    dims: Tuple[int, ...]
    n_flows: int
    n_links_used: int
    lf: torch.Tensor  # (Lu, d) int64
    fl: torch.Tensor  # (F, h) int64
    cap: torch.Tensor  # (Lu,) float64
    has_links: np.ndarray  # (F,) bool
    vol: np.ndarray  # (F,) float64
    max_iters: int
    device: torch.device
    links: np.ndarray  # (Lu,) int64: used link l's id in the full layout
    n_slots: int  # size of the full link layout


def prepare_drain(
    paths, link_bw: float = 1.0, double_link_on_2: bool = True, device: DeviceLike = "cuda"
) -> DrainPlan:
    """Compact a :class:`repro_torch.network.netsim.FlowPaths` into a
    :class:`DrainPlan` (host-side ``np.unique``/argsort work, as in the JAX
    package), then move its index lists and capacities to ``device``."""
    from repro_torch.network.netsim import link_capacities

    dev = resolve_device(device)
    if link_bw <= 0.0:
        raise ValueError("link_bw must be positive")
    if getattr(paths, "capacities", None) is not None:
        # Explicit-capacity fabrics (HyperX) carry their own dense slot
        # capacities in units of link_bw; the torus double-link rule does
        # not apply to them.
        capfull = np.asarray(paths.capacities, dtype=np.float64) * link_bw
    else:
        capfull = link_capacities(paths.dims, link_bw, double_link_on_2).ravel()
    F = paths.n_flows
    link = paths.link_ids
    flow = paths.flow_ids
    uniq, inv = np.unique(link, return_inverse=True)
    Lu = int(uniq.shape[0])
    cap = capfull[uniq]
    order = np.argsort(inv, kind="stable")
    li = inv[order]
    fi = flow[order]
    starts = np.searchsorted(li, np.arange(Lu))
    pos = np.arange(li.shape[0]) - starts[li]
    d = int(pos.max()) + 1 if li.shape[0] else 0
    lf = np.full((Lu, max(d, 1)), F, dtype=np.int64)
    if li.shape[0]:
        lf[li, pos] = fi
    order2 = np.argsort(flow, kind="stable")
    fi2 = flow[order2]
    li2 = inv[order2]
    s2 = np.searchsorted(fi2, np.arange(F))
    pos2 = np.arange(fi2.shape[0]) - s2[fi2]
    h = int(pos2.max()) + 1 if fi2.shape[0] else 0
    fl = np.full((F, max(h, 1)), Lu, dtype=np.int64)
    if fi2.shape[0]:
        fl[fi2, pos2] = li2
    has_links = np.zeros(F, dtype=bool)
    has_links[flow] = True
    return DrainPlan(
        dims=tuple(paths.dims),
        n_flows=F,
        n_links_used=Lu,
        lf=_tensor(lf, dev),
        fl=_tensor(fl, dev),
        cap=_tensor(cap, dev),
        has_links=has_links,
        vol=np.asarray(paths.vol, dtype=np.float64),
        max_iters=Lu + 1,
        device=dev,
        links=uniq,
        n_slots=int(capfull.shape[0]),
    )


def _max_min_rates(plan: DrainPlan, growing: torch.Tensor) -> torch.Tensor:
    """Max-min fair rates of each lane's ``growing`` flows ((B, F) bool) by
    progressive filling: every unfrozen flow grows by the least share of
    any open link, the links at that share saturate and freeze their
    flows.  A lane that has converged is frozen (``done``), as the JAX
    loop stops; its later iterations change nothing."""
    B, F = growing.shape
    Lu = plan.n_links_used
    lf = plan.lf.view(-1)
    fl = plan.fl.view(-1)
    pad = torch.zeros(B, 1, dtype=torch.bool, device=growing.device)
    rate = torch.zeros(B, F, dtype=torch.float64, device=growing.device)
    cap_rem = plan.cap.expand(B, Lu).clone()
    growing = growing.clone()
    done = ~growing.any(dim=1)
    it = 0
    while it < plan.max_iters:
        for _ in range(min(CHECK_EVERY, plan.max_iters - it)):
            gpad = torch.cat([growing, pad], dim=1)
            cnt = gpad.index_select(1, lf).view(B, Lu, -1).sum(dim=2, dtype=torch.float64)
            open_ = cnt > 0
            openany = open_.any(dim=1)
            share = torch.where(open_, cap_rem / torch.where(open_, cnt, 1.0), torch.inf)
            inc = share.min(dim=1, keepdim=True).values
            rate2 = torch.where(growing, rate + inc, rate)
            cap2 = torch.where(open_, cap_rem - inc * cnt, cap_rem)
            sat = open_ & (share <= inc * (1.0 + 1e-9))
            spad = torch.cat([sat, pad], dim=1)
            growing2 = growing & ~spad.index_select(1, fl).view(B, F, -1).any(dim=2)
            step = (~done & openany).unsqueeze(1)
            done = done | ~openany | ~growing2.any(dim=1)
            growing = torch.where(step, growing2, growing)
            cap_rem = torch.where(step, cap2, cap_rem)
            rate = torch.where(step, rate2, rate)
            it += 1
        if bool(done.all()):
            break
    return rate


def _drain_lanes(
    plan: DrainPlan, vols: torch.Tensor, active: torch.Tensor, max_steps: int,
    timeline: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Drain B lanes together: (completion (B, F), steps (B,), whether a
    lane still had active flows after ``max_steps`` steps).  Each step
    gives every live lane's active flows their max-min rates, advances the
    lane's clock to its next completion (the first flow of least
    remaining/rate; ties go to the lowest flow index, as ``np.argmin``
    and ``jnp.argmin`` take them) and retires the flows that drained.

    With a ``timeline`` list (one lane), each step appends, on the
    device, its ``[start, end, max, mean, active flows]`` and the
    utilization of every used link: the step's rates summed over the
    link's flows, over its capacity; max and mean over links in use."""
    B, F = vols.shape
    dev = vols.device
    tolv = vols.clamp(min=1.0) * _EPS
    t = torch.zeros(B, dtype=torch.float64, device=dev)
    remaining = vols.clone()
    fc = torch.zeros(B, F, dtype=torch.float64, device=dev)
    steps = torch.zeros(B, dtype=torch.int64, device=dev)
    active = active.clone()
    while True:
        live = active.any(dim=1) & (steps < max_steps)
        if not bool(live.any()):
            break
        L = live.unsqueeze(1)
        rates = _max_min_rates(plan, active & L)
        ratio = torch.where(active, remaining / torch.where(active, rates, 1.0), torch.inf)
        amin = ratio.argmin(dim=1, keepdim=True)
        dt = ratio.gather(1, amin)
        t2 = t.unsqueeze(1) + dt
        if timeline is not None:
            timeline.append(_utilization_sample(plan, rates[0], t2[0, 0] - dt[0, 0], t2[0, 0], active[0]))
        rem2 = torch.where(active, remaining - rates * dt, remaining).scatter_(1, amin, 0.0)
        finished = active & (rem2 <= tolv) & L
        t = torch.where(live, t2.squeeze(1), t)
        remaining = torch.where(L, rem2, remaining)
        fc = torch.where(finished, t2, fc)
        active = active & ~finished
        steps = steps + live.long()
    return fc, steps, bool(active.any())


def _utilization_sample(
    plan: DrainPlan, rates: torch.Tensor, start: torch.Tensor, end: torch.Tensor, active: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's timeline entry on the device: ``[start, end, max, mean,
    active flows]`` and the (Lu,) used-link utilization."""
    rpad = torch.cat([rates, rates.new_zeros(1)])
    used = rpad[plan.lf.view(-1)].view(plan.n_links_used, -1).sum(dim=1)
    util = torch.where(plan.cap > 0.0, used / torch.where(plan.cap > 0.0, plan.cap, 1.0), 0.0)
    busy = used > 0.0
    n_busy = busy.sum()
    peak = torch.where(busy, util, 0.0).max()
    mean = torch.where(n_busy > 0, torch.where(busy, util, 0.0).sum() / n_busy.clamp(min=1), 0.0)
    stats = torch.stack([start, end, peak, mean, active.sum().to(torch.float64)])
    return stats, util


def _drain_checked(
    plan: DrainPlan, vols: np.ndarray, max_steps: int, name: str, timeline: Optional[list] = None
) -> Tuple[np.ndarray, np.ndarray]:
    B = vols.shape[0]
    active0 = plan.has_links[None, :] & (vols > _EPS)
    if plan.n_links_used == 0 or not active0.any():
        return np.zeros((B, plan.n_flows)), np.zeros(B, dtype=np.int64)
    count_dispatch(name, plan.device.type)
    fc, steps, unfinished = _drain_lanes(
        plan, _tensor(vols, plan.device), _tensor(active0, plan.device), int(max_steps), timeline
    )
    if unfinished:
        raise RuntimeError(f"flow simulation exceeded {max_steps} steps")
    return fc.cpu().numpy(), steps.cpu().numpy()


def drain(plan: DrainPlan, vol: Optional[np.ndarray] = None, max_steps: int = 100_000) -> Tuple[np.ndarray, int]:
    """Drain one scenario: ``(flow_completion, steps)``, matching
    ``repro.network.netsim.simulate_flows`` (completions within 1e-9
    relative, the same steps).  ``vol`` overrides the plan's subflow
    volumes (same flow order).  Raises ``RuntimeError`` past
    ``max_steps``, as the NumPy engine does."""
    v = plan.vol if vol is None else np.asarray(vol, dtype=np.float64)
    if v.shape != (plan.n_flows,):
        raise ValueError(f"vol must have shape ({plan.n_flows},); got {v.shape}")
    fc, steps = _drain_checked(plan, v[None], max_steps, "drain")
    return fc[0], int(steps[0])


def drain_timeline(
    plan: DrainPlan, max_steps: int = 100_000
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """:func:`drain` of the plan's own volumes, recording the utilization
    timeline on the device as it goes: ``(flow_completion, steps, stats,
    util)`` with ``stats`` (steps, 5) rows ``[start, end, max, mean,
    active flows]`` and ``util`` (steps, n_slots) each step's utilization
    of every link of the full layout (zero where unused), as the NumPy
    engine's ``record_utilization=True`` records them (samples within
    1e-9 relative: a link's rates are summed in another order)."""
    samples: list = []
    fc, steps = _drain_checked(plan, plan.vol[None], max_steps, "drain", samples)
    if not samples:
        return fc[0], int(steps[0]), np.zeros((0, 5)), np.zeros((0, plan.n_slots))
    stats = torch.stack([st for st, _ in samples]).cpu().numpy()
    used = torch.stack([u for _, u in samples]).cpu().numpy()
    util = np.zeros((used.shape[0], plan.n_slots))
    util[:, plan.links] = used
    return fc[0], int(steps[0]), stats, util


def drain_batch(plan: DrainPlan, vols: np.ndarray, max_steps: int = 100_000) -> Tuple[np.ndarray, np.ndarray]:
    """Drain a batch of volume lanes through one plan: ``vols`` is
    ``(B, F)``, one scenario per row, all sharing the plan's incidence.
    The lanes run together on the plan's device, each frozen once it has
    drained, so every lane equals :func:`drain` on that lane bit for bit.
    Returns ``(flow_completion (B, F), steps (B,))``."""
    vols = np.asarray(vols, dtype=np.float64)
    if vols.ndim != 2 or vols.shape[1] != plan.n_flows:
        raise ValueError(f"vols must have shape (B, {plan.n_flows}); got {vols.shape}")
    return _drain_checked(plan, vols, max_steps, "drain_batch")


# ---------------------------------------------------------------------------
# Batched candidate scoring.
# ---------------------------------------------------------------------------
#: Device memory one :func:`score_candidates` chunk may take (bytes).
#: Scores are row-exact, so the chunking cannot change a result.
SCORE_BUDGET_BYTES = 1 << 30


def score_chunk(dims: Sequence[int], n_messages: int) -> int:
    """Candidates scored together under :data:`SCORE_BUDGET_BYTES`: per candidate,
    the (M, D) endpoint pairs, about a dozen (M,) temporaries per
    dimension, the difference array's six index/weight entries per
    message and its (2, N) planes."""
    dims = tuple(int(a) for a in dims)
    per = n_messages * (16 * len(dims) + 8 * 12 + 16 * 6) + 16 * 2 * volume(dims)
    return max(1, SCORE_BUDGET_BYTES // max(per, 1))


def score_candidates(
    dims: Sequence[int],
    coords: np.ndarray,
    traffic,
    split_ties: bool = True,
    double_link_on_2: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(congestion, dilation) of B candidate rank mappings.  ``coords`` is
    ``(B, n_ranks, D)`` (or one ``(n_ranks, D)`` mapping) and ``traffic``
    the shared rank-space ``(src_rank, dst_rank, vol)``.  Row-identical to
    ``repro.network.mapping.score_mapping`` per candidate for integer or
    dyadic volumes.

    Each candidate's messages are routed as :func:`route_loads` routes
    them, with the lane folded into the difference array's index, so the
    batch runs in O(B (M + N)) memory; larger batches than
    :data:`SCORE_BUDGET_BYTES` allows run in chunks of :func:`score_chunk`
    candidates, one dispatch each."""
    dev = resolve_device(device)
    dims = tuple(int(a) for a in dims)
    coords = np.asarray(coords, dtype=np.int64)
    if coords.ndim == 2:
        coords = coords[None]
    if coords.ndim != 3 or coords.shape[2] != len(dims):
        raise ValueError(f"coords must have shape (B, n_ranks, {len(dims)}); got {coords.shape}")
    B = coords.shape[0]
    rsrc, rdst, vol = traffic
    rsrc = np.asarray(rsrc, dtype=np.int64)
    rdst = np.asarray(rdst, dtype=np.int64)
    if B == 0 or rsrc.shape[0] == 0:
        return np.zeros(B), np.zeros(B)
    vol = np.broadcast_to(np.asarray(vol, dtype=np.float64), rsrc.shape)
    rs, rd, v = _tensor(rsrc, dev), _tensor(rdst, dev), _tensor(vol, dev)
    step = score_chunk(dims, rsrc.shape[0])
    cong, dil = [], []
    for lo in range(0, B, step):
        count_dispatch("score_candidates", dev.type)
        c, d = _score_lanes(dims, _tensor(coords[lo:lo + step], dev), rs, rd, v, split_ties, double_link_on_2)
        cong.append(c.cpu().numpy())
        dil.append(d.cpu().numpy())
    return np.concatenate(cong), np.concatenate(dil)


def _score_lanes(
    dims: Tuple[int, ...],
    c: torch.Tensor,
    rsrc: torch.Tensor,
    rdst: torch.Tensor,
    v: torch.Tensor,
    split_ties: bool,
    double_link_on_2: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, n_ranks, D = c.shape
    M = rsrc.shape[0]
    cd = c.permute(2, 0, 1).contiguous()  # (D, B, n): each dimension's coordinates contiguous
    lane = torch.arange(B, device=c.device).unsqueeze(1) * n_ranks
    isrc, idst = (lane + rsrc).reshape(-1), (lane + rdst).reshape(-1)  # flat gathers are the fast ones

    def gather(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return x.reshape(-1)[i].view(B, M)

    vb = v.expand(B, M)
    cong = torch.zeros(B, dtype=torch.float64, device=c.device)
    hops_total = torch.zeros(B, M, dtype=torch.int64, device=c.device)
    mixed = gather(_flat(dims, cd.permute(1, 2, 0)), isrc)
    for k, (a, stride) in enumerate(zip(dims, _strides(dims))):
        if a == 1:
            continue
        s, d = gather(cd[k], isrc), gather(cd[k], idst)
        delta = torch.remainder(d - s, a)
        hops_total += torch.minimum(delta, a - delta)
        peak = _ring_loads(dims, k, mixed, s, d, vb, split_ties).view(B, -1).amax(dim=1)
        scale = 0.5 if (a == 2 and double_link_on_2) else 1.0
        cong = torch.maximum(cong, scale * peak)
        mixed = mixed + (d - s) * stride
    dil = (v * hops_total.to(torch.float64)).sum(dim=1)
    return cong, dil


# ---------------------------------------------------------------------------
# (3) FFT contention cross-correlation.
# ---------------------------------------------------------------------------
def _plane_axes(t: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(2, t.ndim))


def contention_field(mask: np.ndarray, J: np.ndarray, device: DeviceLike = "cuda") -> np.ndarray:
    """Overlap of a job's load field ``J`` with the interference ``mask``
    at every torus offset, both ``(D, 2, *dims)``:

        C[o] = sum_{k,d,v} J[k,d][(v - o) mod dims] * mask[k,d][v]

    as one batched FFT cross-correlation over the plane axes, clamped at
    zero.  Values carry FFT round-off (~1e-12)."""
    dev = resolve_device(device)
    m = _tensor(np.asarray(mask, dtype=np.float64), dev)
    j = _tensor(np.asarray(J, dtype=np.float64), dev)
    if m.shape != j.shape:
        raise ValueError(f"mask and load field shapes differ: {tuple(m.shape)} / {tuple(j.shape)}")
    count_dispatch("contention_field", dev.type)
    axes = _plane_axes(m)
    corr = torch.fft.ifftn(torch.fft.fftn(m, dim=axes) * torch.fft.fftn(j, dim=axes).conj(), dim=axes)
    return corr.real.sum(dim=(0, 1)).clamp(min=0.0).cpu().numpy()


def mask_fft(mask: torch.Tensor) -> torch.Tensor:
    """The FFT of every (dimension, direction) plane of an interference
    mask, once per placement search (its orientations share it)."""
    return torch.fft.fftn(mask.to(torch.float64), dim=_plane_axes(mask))


def snapped_contention(mask_ffts: torch.Tensor, J_int: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contention field of an integer load field ``J_int`` ((D, 2,
    *dims) int64) against a mask given by :func:`mask_fft`, rounded to
    the integer it is (a sum of integers over a 0/1 mask), and the largest
    distance of the FFT's value from it.  Both stay on the device: the
    field is exact on either device, so the ranking built on it is too."""
    count_dispatch("contention_field", J_int.device.type)
    axes = _plane_axes(J_int)
    j = torch.fft.fftn(J_int.to(torch.float64), dim=axes)
    raw = torch.fft.ifftn(mask_ffts * j.conj(), dim=axes).real.sum(dim=(0, 1))
    snapped = torch.round(raw)
    return snapped, (raw - snapped).abs().max()


# ---------------------------------------------------------------------------
# (4) Closed-form cut scoring.
# ---------------------------------------------------------------------------
def cut_scores(
    dims: Sequence[int], assignments: np.ndarray, t: int, device: DeviceLike = "cuda"
) -> np.ndarray:
    """For each aligned side assignment ``S`` of a volume-``t`` cuboid in
    torus ``dims``, the exact cut ``sum_k (0 if S_k == dims_k else 2t /
    S_k)`` in int64: the JAX package's values exactly."""
    dev = resolve_device(device)
    S = np.asarray(assignments, dtype=np.int64)
    if S.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    count_dispatch("cut_scores", dev.type)
    s = _tensor(S, dev)
    av = torch.tensor([int(a) for a in dims], dtype=torch.int64, device=dev)
    return ((2 * int(t)) // s).masked_fill(s == av, 0).sum(dim=1).cpu().numpy()


def hamming_cut_scores(
    dims: Sequence[int], mult: Sequence[int], assignments: np.ndarray, t: int, device: DeviceLike = "cuda"
) -> np.ndarray:
    """For each aligned box ``S`` of volume ``t`` in the Hamming graph
    ``H(dims)`` with link multiplicities ``mult``, the exact cut ``t *
    sum_k K_k (S_k - c_k)`` in int64: a covered dimension contributes
    nothing."""
    dev = resolve_device(device)
    S = np.asarray(assignments, dtype=np.int64)
    if S.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    count_dispatch("hamming_cut_scores", dev.type)
    s = _tensor(S, dev)
    av = torch.tensor([int(a) for a in dims], dtype=torch.int64, device=dev)
    kv = torch.tensor([int(k) for k in mult], dtype=torch.int64, device=dev)
    return (int(t) * kv * (av - s)).sum(dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# (5) Minimal-adaptive torus routing.
# ---------------------------------------------------------------------------
def _segment_links_t(
    a: int, stride: int, plane_base: torch.Tensor, base_vflat: torch.Tensor, start: torch.Tensor,
    hops: torch.Tensor, fwd: torch.Tensor, flow_idx: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The directed links of a batch of ring segments, flat ids and owning
    flows, in the NumPy engine's order (segment by segment, hop by hop):
    a forward segment from ring position ``s`` of ``h`` hops uses the '+'
    links leaving ``s, .., s+h-1``, a backward one the '-' links leaving
    ``s, .., s-h+1``."""
    rep = torch.repeat_interleave(torch.arange(hops.shape[0], device=hops.device), hops)
    first = torch.cumsum(hops, 0) - hops
    j = torch.arange(rep.shape[0], device=hops.device) - first[rep]
    sgn = torch.where(fwd, 1, -1)[rep]
    pos = torch.remainder(start[rep] + sgn * j, a)
    return plane_base[rep] + base_vflat[rep] + pos * stride, flow_idx[rep]


def adaptive_links(
    dims: Sequence[int],
    messages: Tuple[np.ndarray, np.ndarray, np.ndarray],
    flows: Tuple[np.ndarray, np.ndarray, np.ndarray],
    split_ties: bool = True,
    divert_margin: float = 0.75,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """The link incidence ``(link_ids, flow_ids)`` of the NumPy engine's
    minimal-adaptive router (``repro.network.netsim.adaptive_paths``), on
    ``device``.

    ``messages`` is the ``(src, dst, vol)`` batch, ``flows`` its subflows'
    ``(src, dst, fwd)`` after tie expansion.  Pass 1 is the messages' DOR
    link-load field (:func:`route_loads`' pass; for integer or dyadic
    volumes the subflows' field exactly).  Pass 2 prices every unrouted
    dimension of every flow at once against that frozen field, as the
    mean load along the candidate segment (per (dimension, direction)
    ``cumsum`` prefixes, two gathers per segment), and routes a whole
    dimension per round: DOR's lowest remaining dimension unless the
    cheapest one costs less than ``divert_margin`` times it (``argmin``
    ties to the lowest dimension).  With an exact field the decisions,
    and so the ids, equal the NumPy engine's."""
    dev = resolve_device(device)
    dims = tuple(int(a) for a in dims)
    D = len(dims)
    n = volume(dims)
    msrc, mdst, mvol = (_tensor(np.asarray(x), dev) for x in messages)
    src, dst, fwd = (_tensor(np.asarray(x), dev) for x in flows)
    F = src.shape[0]
    if F == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy()
    count_dispatch("adaptive_links", dev.type)
    field = _route_loads(dims, msrc.long(), mdst.long(), mvol.double(), bool(split_ties))
    prefix = torch.stack([torch.cumsum(field[k], dim=1 + k).reshape(2 * n) for k in range(D)])  # (D, 2N)
    av = torch.tensor(dims, dtype=torch.int64, device=dev)
    strides = torch.tensor(_strides(dims), dtype=torch.int64, device=dev)
    hops = torch.minimum(torch.remainder(dst - src, av), torch.remainder(src - dst, av))
    cur = src.clone()
    remaining = hops > 0
    rowsel = torch.arange(F, device=dev)
    links, owners = [], []
    for _ in range(D):
        if not bool(remaining.any()):
            break
        act = remaining.any(dim=1)
        cost = torch.full((F, D), torch.inf, dtype=torch.float64, device=dev)
        base_all = _flat(dims, cur)
        for k, a in enumerate(dims):
            rows = torch.nonzero(remaining[:, k]).squeeze(1)
            if rows.shape[0] == 0:
                continue
            h, s, fw = hops[rows, k], cur[rows, k], fwd[rows, k]
            st = strides[k]
            start = torch.where(fw, s, torch.remainder(s - h + 1, a))
            b = base_all[rows] - s * st + (~fw).long() * n  # the '-' prefix follows the '+' one
            end = start + h - 1
            cs = prefix[k]
            t_end = cs[b + torch.remainder(end, a) * st]
            t_sm1 = torch.where(start > 0, cs[b + (start - 1).clamp(min=0) * st], 0.0)
            ring = cs[b + (a - 1) * st]
            seg = t_end - t_sm1 + torch.where(end >= a, ring, 0.0)
            cost[rows, k] = seg / h
        best = cost.argmin(dim=1)
        default = remaining.to(torch.int8).argmax(dim=1)  # lowest remaining dimension
        divert = cost[rowsel, best] < divert_margin * cost[rowsel, default]
        choice = torch.where(divert, best, default)
        for k, a in enumerate(dims):
            g = torch.nonzero(act & (choice == k) & remaining[:, k]).squeeze(1)
            if g.shape[0] == 0:
                continue
            s = cur[g, k]
            base_vflat = base_all[g] - s * strides[k]
            plane = torch.where(fwd[g, k], 2 * k, 2 * k + 1) * n
            lk, fk = _segment_links_t(a, _strides(dims)[k], plane, base_vflat, s, hops[g, k], fwd[g, k], g)
            links.append(lk)
            owners.append(fk)
            cur[g, k] = dst[g, k]
            remaining[g, k] = False
    if not links:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy()
    return torch.cat(links).cpu().numpy(), torch.cat(owners).cpu().numpy()


# ---------------------------------------------------------------------------
# (6) HyperX routing: minimal (dimension-ordered direct hops) and DAL.
# ---------------------------------------------------------------------------
def hyperx_blocks(dims: Tuple[int, ...]) -> Tuple[List[int], int]:
    """Per-dimension slot-block starts of the HyperX link-id layout
    (:meth:`repro_torch.network.fabric.HyperXFabric.links`) and the total
    dense slot count ``N * sum(S_k)``."""
    n = volume(dims)
    bases: List[int] = []
    b = 0
    for a in dims:
        bases.append(b)
        b += n * a
    return bases, b


def hyperx_candidate_orders(D: int) -> List[Tuple[int, ...]]:
    """DAL's candidate dimension orders: the D cyclic rotations of the
    canonical order (rotation 0 is minimal routing)."""
    base = tuple(range(D))
    return [base[r:] + base[:r] for r in range(max(D, 1))]


def _hyperx_order_links(
    dims: Tuple[int, ...], src: torch.Tensor, dst: torch.Tensor, order: Sequence[int]
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-hop ``(link_ids, message_idx)`` of every message under one
    dimension order: each differing coordinate is one direct clique hop
    from the current cell, in the NumPy engine's order."""
    bases, _ = hyperx_blocks(dims)
    cur = src.clone()
    out: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for k in order:
        a = dims[k]
        if a > 1:
            idx = torch.nonzero(cur[:, k] != dst[:, k]).squeeze(1)
            if idx.shape[0]:
                out.append((bases[k] + _flat(dims, cur[idx]) * a + dst[idx, k], idx))
        cur[:, k] = dst[:, k]
    return out


def hyperx_flows(
    dims: Sequence[int],
    src: np.ndarray,
    dst: np.ndarray,
    vol: np.ndarray,
    mode: str = "minimal",
    rounds: int = 2,
    balance_rtol: float = 1e-9,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Messages expanded into routed subflows on a HyperX fabric, on
    ``device``: ``(msg, fvol, link_ids, flow_ids)`` tensors in the NumPy
    engine's order (``repro.network.routing._hyperx_flows``).

    ``"minimal"`` routes the canonical dimension order.  ``"dal"`` splits
    each message over the candidate orders by the inverse of each order's
    bottleneck load, ``rounds`` times from the minimal field: the field is
    an ``index_add_`` over every order's hops, each (message, order)
    bottleneck a ``scatter_reduce`` (``amax``), and a message whose
    bottlenecks agree within ``balance_rtol`` keeps the minimal order.
    Round 1's field is minimal routing's, exact for integer volumes, so
    its decisions equal the NumPy engine's; fractional loads after it sum
    in another order (within 1e-12 relative)."""
    dev = resolve_device(device)
    dims = tuple(int(a) for a in dims)
    D = len(dims)
    src = np.atleast_2d(np.asarray(src, dtype=np.int64))
    dst = np.atleast_2d(np.asarray(dst, dtype=np.int64))
    if src.shape != dst.shape or src.shape[1] != D:
        raise ValueError(f"src/dst must have shape (M, {D}); got {src.shape}/{dst.shape}")
    if mode not in ("minimal", "dal"):
        raise ValueError(f"unknown HyperX routing mode {mode!r}; expected 'minimal' or 'dal'")
    hi = np.asarray(dims, dtype=np.int64)
    if ((src < 0) | (src >= hi) | (dst < 0) | (dst >= hi)).any():
        raise ValueError(f"src/dst coordinates must lie in the fabric {dims}")
    M = src.shape[0]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if M == 0:
        return empty, torch.zeros(0, dtype=torch.float64, device=dev), empty.clone(), empty.clone()
    count_dispatch("hyperx_flows", dev.type)
    _, n_slots = hyperx_blocks(dims)
    vol_t = _tensor(np.broadcast_to(np.asarray(vol, dtype=np.float64), (M,)), dev)
    s_t, d_t = _tensor(src, dev), _tensor(dst, dev)
    orders = hyperx_candidate_orders(D) if mode == "dal" else [tuple(range(D))]
    per_order = [_hyperx_order_links(dims, s_t, d_t, o) for o in orders]
    R = len(orders)
    weights = torch.zeros(M, R, dtype=torch.float64, device=dev)
    weights[:, 0] = 1.0
    if mode == "dal":
        tiny = 1e-300
        for _ in range(max(rounds, 1)):
            loads = torch.zeros(n_slots, dtype=torch.float64, device=dev)
            for r, hops in enumerate(per_order):
                w = weights[:, r] * vol_t
                for ids, idx in hops:
                    loads.index_add_(0, ids, w[idx])
            cost = torch.zeros(R, M, dtype=torch.float64, device=dev)
            for r, hops in enumerate(per_order):
                for ids, idx in hops:
                    cost[r].scatter_reduce_(0, idx, loads[ids], reduce="amax")
            cost = cost.T
            cmax = cost.max(dim=1).values
            cmin = cost.min(dim=1).values
            skewed = cmax - cmin > balance_rtol * cmax.clamp(min=tiny)
            inv = 1.0 / cost.clamp(min=tiny)
            frac = inv / inv.sum(dim=1, keepdim=True)
            minimal = torch.zeros_like(weights)
            minimal[:, 0] = 1.0
            weights = torch.where(skewed[:, None], frac, minimal)
    msg_l, fvol_l, link_l, flow_l = [], [], [], []
    f_base = 0
    for r, hops in enumerate(per_order):
        live = torch.nonzero(weights[:, r] > 0.0).squeeze(1)
        if live.shape[0] == 0:
            continue
        pos = torch.full((M,), -1, dtype=torch.int64, device=dev)
        pos[live] = f_base + torch.arange(live.shape[0], device=dev)
        msg_l.append(live)
        fvol_l.append(weights[live, r] * vol_t[live])
        for ids, idx in hops:
            p = pos[idx]
            sel = p >= 0
            link_l.append(ids[sel])
            flow_l.append(p[sel])
        f_base += live.shape[0]
    cat = lambda xs, e: torch.cat(xs) if xs else e  # noqa: E731
    return (cat(msg_l, empty), cat(fvol_l, torch.zeros(0, dtype=torch.float64, device=dev)),
            cat(link_l, empty.clone()), cat(flow_l, empty.clone()))


def hyperx_loads(fvol: torch.Tensor, link_ids: torch.Tensor, flow_ids: torch.Tensor, n_slots: int) -> np.ndarray:
    """The flat per-slot loads of :func:`hyperx_flows`' subflows (an
    ``index_add_`` on their device; exact for integer volumes)."""
    out = torch.zeros(n_slots, dtype=torch.float64, device=fvol.device)
    out.index_add_(0, link_ids, fvol[flow_ids])
    return out.cpu().numpy()
