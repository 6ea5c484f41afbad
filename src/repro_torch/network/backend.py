"""The network engines' hot passes in torch (port of the ``xla`` backend of
``repro.network.backend``).

The JAX package runs these passes under ``jax.jit`` so that the planner,
scheduler and advisor can score thousands of candidates per call.  Here
they are eager torch in float64 and int64, on the card unless the caller
passes ``device="cpu"``, where the same code runs on the CPU:

=======================  ====================================================
:func:`route_loads`      the DOR difference-array link-load tensor
                         (``index_add_`` + ``cumsum``)
:func:`prepare_drain`    the link x flow incidence compacted to ELL on the
                         host; the index lists and capacities move to the
                         device once
:func:`drain`            max-min progressive filling
:func:`drain_batch`      many volume lanes of one plan, run together
:func:`score_candidates` congestion and dilation of B candidate mappings in
                         one batched pass
:func:`contention_field` the FFT cross-correlation over all load planes
:func:`cut_scores`       the closed-form cuboid cut in int64
=======================  ====================================================

Exactness.  Link loads are sums of integer volumes, halved at most once
by a split tie, so every partial sum is exact in float64 whatever the
order: the card's ``index_add_`` and ``cumsum`` sum in a nondeterministic
order and still give the NumPy engine's tensor exactly, for integer or
dyadic volumes (for others, to float64 summation order).  The drain's
arithmetic is elementwise or an order-free ``min``/count, so a lane's
completion times do not depend on the device nor on the other lanes.

What stays NumPy: path building, tie expansion and the ELL compaction
(irregular ``np.unique``/argsort work), the divisor enumeration and the
group-by of :func:`repro_torch.network.isoperimetry.cut_table`, and
result packaging.  Eager torch compiles nothing per shape, so the JAX
package's power-of-two message padding and jit-compile counter have no
counterpart; ``repro_torch.obs.DISPATCHES`` counts the calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network.geometry import volume
from repro_torch.obs import count_dispatch

__all__ = [
    "DrainPlan",
    "contention_field",
    "cut_scores",
    "drain",
    "drain_batch",
    "prepare_drain",
    "route_loads",
    "score_candidates",
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


def _line_strides(dims: Tuple[int, ...], k: int) -> Tuple[int, int]:
    """(number of dimension-k rings, C-order strides of the other dims)."""
    other = dims[:k] + dims[k + 1:]
    strides = []
    acc = 1
    for w in reversed(other):
        strides.append(acc)
        acc *= w
    return volume(other), tuple(reversed(strides))


def _ring_line(dims: Tuple[int, ...], k: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Dimension-k ring of each message under DOR: dims below k already
    routed (the destination's coordinates), dims above still at the
    source's.  ``src``/``dst`` are (..., D); the result is (...)."""
    _, strides = _line_strides(dims, k)
    line = torch.zeros(src.shape[:-1], dtype=torch.int64, device=src.device)
    others = [j for j in range(len(dims)) if j != k]
    for j, stride in zip(others, strides):
        line = line + (dst[..., j] if j < k else src[..., j]) * stride
    return line


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


def _route_loads(
    dims: Tuple[int, ...], src: torch.Tensor, dst: torch.Tensor, vol: torch.Tensor, split_ties: bool
) -> torch.Tensor:
    loads = torch.zeros((len(dims), 2) + dims, dtype=torch.float64, device=src.device)
    for k, a in enumerate(dims):
        if a == 1:
            continue
        n_lines, _ = _line_strides(dims, k)
        line = _ring_line(dims, k, src, dst)
        s = src[:, k]
        delta = torch.remainder(dst[:, k] - s, a)
        rev = a - delta
        hops = torch.minimum(delta, rev)
        tie = delta * 2 == a
        fwd = delta <= rev  # ties route forward in the primary segment
        v1 = torch.where(tie, vol * (0.5 if split_ties else 1.0), vol).masked_fill(hops == 0, 0.0)
        bstart = torch.remainder(s - hops + 1, a)
        start = torch.where(fwd, s, bstart)
        base = line * a + (~fwd).long() * (n_lines * a)  # '-' plane offset
        segments = [(start, v1, base)]
        if split_ties:
            # The backward half of each split tie; zero for every other
            # message, which adds nothing to the loads.
            segments.append((bstart, (vol * 0.5).masked_fill(~tie, 0.0), n_lines * a + line * a))
        idx, w = [], []
        for st, v, b in segments:
            end = st + hops
            em = torch.where(end >= a, end - a, end)  # end mod a (end < 2a)
            idx += [b + st, b + em, b]
            w += [v, (-v).masked_fill(em == 0, 0.0), v.masked_fill(end <= a, 0.0)]
        diff = torch.zeros(2 * n_lines * a, dtype=torch.float64, device=src.device)
        diff.index_add_(0, torch.cat(idx), torch.cat(w))
        ring = torch.cumsum(diff.view(2, n_lines, a), dim=-1).clamp_(min=0.0)
        other = dims[:k] + dims[k + 1:]
        loads[k] = ring.view((2,) + other + (a,)).movedim(-1, 1 + k)
    return loads


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
    on ``device``.  ``vol`` is the scenario's own subflow volumes;
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
    plan: DrainPlan, vols: torch.Tensor, active: torch.Tensor, max_steps: int
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Drain B lanes together: (completion (B, F), steps (B,), whether a
    lane still had active flows after ``max_steps`` steps).  Each step
    gives every live lane's active flows their max-min rates, advances the
    lane's clock to its next completion (the first flow of least
    remaining/rate; ties go to the lowest flow index, as ``np.argmin``
    and ``jnp.argmin`` take them) and retires the flows that drained."""
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
        rem2 = torch.where(active, remaining - rates * dt, remaining).scatter_(1, amin, 0.0)
        finished = active & (rem2 <= tolv) & L
        t = torch.where(live, t2.squeeze(1), t)
        remaining = torch.where(L, rem2, remaining)
        fc = torch.where(finished, t2, fc)
        active = active & ~finished
        steps = steps + live.long()
    return fc, steps, bool(active.any())


def _drain_checked(plan: DrainPlan, vols: np.ndarray, max_steps: int, name: str) -> Tuple[np.ndarray, np.ndarray]:
    B = vols.shape[0]
    active0 = plan.has_links[None, :] & (vols > _EPS)
    if plan.n_links_used == 0 or not active0.any():
        return np.zeros((B, plan.n_flows)), np.zeros(B, dtype=np.int64)
    count_dispatch(name, plan.device.type)
    fc, steps, unfinished = _drain_lanes(
        plan, _tensor(vols, plan.device), _tensor(active0, plan.device), int(max_steps)
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
def score_candidates(
    dims: Sequence[int],
    coords: np.ndarray,
    traffic,
    split_ties: bool = True,
    double_link_on_2: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(congestion, dilation) of B candidate rank mappings in one batched
    pass.  ``coords`` is ``(B, n_ranks, D)`` (or one ``(n_ranks, D)``
    mapping) and ``traffic`` the shared rank-space ``(src_rank, dst_rank,
    vol)``.  Row-identical to ``repro.network.mapping.score_mapping`` per
    candidate for integer or dyadic volumes.

    Per dimension each message's forward and backward cyclic segments are
    expanded over the ring's positions and summed into their ring with
    ``index_add_``: O(B * M * a) memory per dimension of length a."""
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
    count_dispatch("score_candidates", dev.type)
    c = _tensor(coords, dev)
    src = c[:, _tensor(rsrc, dev)]  # (B, M, D)
    dst = c[:, _tensor(rdst, dev)]
    v = _tensor(vol, dev).expand(src.shape[:2])
    M = src.shape[1]
    lane = torch.arange(B, device=dev).unsqueeze(1)
    cong = torch.zeros(B, dtype=torch.float64, device=dev)
    hops_total = torch.zeros(B, M, dtype=torch.int64, device=dev)
    for k, a in enumerate(dims):
        s = src[..., k]
        delta = torch.remainder(dst[..., k] - s, a)
        hops = torch.minimum(delta, a - delta)
        hops_total += hops
        if a == 1:
            continue
        n_lines, _ = _line_strides(dims, k)
        line = _ring_line(dims, k, src, dst)
        tie = delta * 2 == a
        fwd = delta <= a - delta
        v1 = torch.where(tie, v * (0.5 if split_ties else 1.0), v).masked_fill(hops == 0, 0.0)
        bstart = torch.remainder(s - hops + 1, a)
        wp = v1.masked_fill(~fwd, 0.0)
        wm = v1.masked_fill(fwd, 0.0)
        if split_ties:
            wm = wm + (v * 0.5).masked_fill(~tie, 0.0)
        pos = torch.arange(a, device=dev)
        covp = torch.remainder(pos - s.unsqueeze(-1), a) < hops.unsqueeze(-1)
        covm = torch.remainder(pos - bstart.unsqueeze(-1), a) < hops.unsqueeze(-1)
        rows = (lane * n_lines + line).view(-1)
        peak = torch.zeros(B, dtype=torch.float64, device=dev)
        for w, cov in ((wp, covp), (wm, covm)):
            plane = torch.zeros(B * n_lines, a, dtype=torch.float64, device=dev)
            plane.index_add_(0, rows, (w.unsqueeze(-1) * cov).view(B * M, a))
            peak = torch.maximum(peak, plane.view(B, -1).amax(dim=1))
        scale = 0.5 if (a == 2 and double_link_on_2) else 1.0
        cong = torch.maximum(cong, scale * peak)
    dil = (v * hops_total.to(torch.float64)).sum(dim=1)
    return cong.cpu().numpy(), dil.cpu().numpy()


# ---------------------------------------------------------------------------
# (3) FFT contention cross-correlation.
# ---------------------------------------------------------------------------
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
    axes = tuple(range(2, m.ndim))
    corr = torch.fft.ifftn(torch.fft.fftn(m, dim=axes) * torch.fft.fftn(j, dim=axes).conj(), dim=axes)
    return corr.real.sum(dim=(0, 1)).clamp(min=0.0).cpu().numpy()


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
