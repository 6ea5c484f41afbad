"""Cuboid placement over occupancy grids (port of ``repro.network.placement``).

Given a boolean occupancy grid over the machine torus and an oriented
cuboid, every free translate comes out of one separable circular windowed
sum per dimension (a cumsum over the grid extended by its first ``w - 1``
slices; integer exact), and the scored search ranks all of them at once:

1. predicted contention — the job's all-to-all load field over links
   leaving occupied cells or carrying background traffic, at every offset
   by one FFT cross-correlation (:func:`repro_torch.network.backend.
   snapped_contention`);
2. contact — occupied cells in the one-cell shell around the candidate,
   on fabrics where placements cannot interfere;
3. the reference scan order (orientation, then C-order offset).

The grid, the windowed sums, the load fields and the fields' FFTs live on
``device``; :func:`best_placement` brings only each orientation's winner
back to the host, in one transfer.

Deliberate difference from the JAX package: the JAX search rounds the raw
FFT field to 9 decimals, so a value on a 9-decimal boundary (n = 512:
1/1024 = 0.0009765625) ranks by FFT noise, which differs between
devices.  Here the field is correlated with the integer-scaled load field
(:func:`int_base_loads`), rounded to the integer it is, and divided by
``2 n``: the exact value, identical on the card and the CPU, is what is
rounded to 9 decimals and ranked.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network import backend
from repro_torch.network.geometry import Geometry, bisection_links, canonical
from repro_torch.network.routing import route_dor
from repro_torch.obs import TRACER as _TRACER
from repro_torch.obs import count_dispatch

Coord = Tuple[int, ...]

__all__ = [
    "ScoredPlacement",
    "base_loads",
    "best_placement",
    "contention_field",
    "fabric_can_interfere",
    "first_fit",
    "free_offset_mask",
    "int_base_loads",
    "int_placement_loads",
    "interference_mask",
    "is_spilling",
    "iter_free_placements",
    "orientations",
    "pad_geometry",
    "placement_all_to_all_traffic",
    "placement_cells",
    "placement_loads",
    "placement_pairing_traffic",
    "shared_link_contention",
    "shell_contact",
]

#: Largest distance the FFT's contention value may lie from its integer
#: before the search refuses it: the field is a sum of integers, so a
#: larger gap means the FFT lost the integer (never seen; about 1e-6 at
#: the sizes of the paper's machines).
SNAP_TOLERANCE = 0.25

#: Ordered pairs of cells routed together when an all-to-all load field
#: is built (the chunk bounds the device memory of large jobs).
PAIR_CHUNK = 1 << 22


def pad_geometry(geometry: Sequence[int], ndim: int) -> Geometry:
    """Canonicalise and pad a requested geometry to the machine's rank.

    Trailing 1s beyond the machine rank are harmless and stripped; a
    geometry with more *non-trivial* dimensions than the machine is an
    error.
    """
    g = canonical(geometry)
    while len(g) > ndim and g[-1] == 1:
        g = g[:-1]
    if len(g) > ndim:
        raise ValueError(
            f"geometry {canonical(geometry)} has {len(g)} non-trivial dims; "
            f"machine has only {ndim}"
        )
    return g + (1,) * (ndim - len(g))


def orientations(geometry: Sequence[int], dims: Sequence[int]) -> List[Tuple[int, ...]]:
    """Distinct axis-assignments of the cuboid that fit the machine, in the
    reference scan's order: ``sorted(set(permutations(padded)))``."""
    dims = tuple(dims)
    g = pad_geometry(geometry, len(dims))
    return [
        perm
        for perm in sorted(set(itertools.permutations(g)))
        if all(s <= a for s, a in zip(perm, dims))
    ]


# ---------------------------------------------------------------------------
# The windowed sums, on tensors.
# ---------------------------------------------------------------------------
def as_grid(grid, device: DeviceLike = "cuda") -> torch.Tensor:
    """An occupancy grid (NumPy or tensor) as a bool tensor on ``device``."""
    dev = resolve_device(device)
    if isinstance(grid, torch.Tensor):
        return grid.to(device=dev, dtype=torch.bool)
    return torch.from_numpy(np.array(grid, dtype=bool)).to(dev)


def window_sums(occ: torch.Tensor, extents: Sequence[int]) -> torch.Tensor:
    """S[j] = occupied cells in the box of the given extents whose lowest
    corner sits at offset j (circular in every dim), for an int64 grid."""
    s = occ
    for k, w in enumerate(extents):
        w = int(w)
        a = s.shape[k]
        if w == 1:
            continue
        if not 1 <= w <= a:
            raise ValueError(f"window {w} exceeds grid extent {a} in dim {k}")
        c = torch.cumsum(torch.cat([s, s.narrow(k, 0, w - 1)], dim=k), dim=k)
        lower = torch.cat([torch.zeros_like(c.narrow(k, 0, 1)), c.narrow(k, 0, a - 1)], dim=k)
        s = c.narrow(k, w - 1, a) - lower
    return s


def contact_sums(occ: torch.Tensor, oriented: Sequence[int]) -> torch.Tensor:
    """Occupied cells in the one-cell shell around the cuboid at every
    offset (valid wherever the offset itself is free): the windowed sum of
    the cuboid dilated by one cell per side, clipped to the full ring."""
    dims = tuple(occ.shape)
    extents = tuple(min(w + 2, a) for w, a in zip(oriented, dims))
    sums = window_sums(occ, extents)
    shift = [1 if e == w + 2 else 0 for e, w in zip(extents, oriented)]
    if any(shift):
        sums = torch.roll(sums, shift, dims=tuple(range(len(dims))))
    return sums


def _circular_window_sums(occ, extents: Sequence[int], device: DeviceLike = "cuda") -> np.ndarray:
    """:func:`window_sums` of a grid on ``device``, as NumPy."""
    return window_sums(as_grid(occ, device).long(), extents).cpu().numpy()


def free_offset_mask(grid, oriented: Sequence[int], device: DeviceLike = "cuda") -> np.ndarray:
    """Boolean mask over all torus offsets: True where the oriented cuboid
    placed at that offset covers only free cells."""
    return _circular_window_sums(grid, tuple(oriented), device) == 0


def shell_contact(grid, oriented: Sequence[int], device: DeviceLike = "cuda") -> np.ndarray:
    """Occupied-cell count in the one-cell shell around the cuboid at every
    offset (valid wherever the offset itself is free)."""
    return contact_sums(as_grid(grid, device).long(), tuple(oriented)).cpu().numpy()


def iter_free_placements(
    grid, geometry: Sequence[int], device: DeviceLike = "cuda"
) -> Iterator[Tuple[Tuple[int, ...], np.ndarray]]:
    """Yield ``(oriented, free_mask)`` per fitting orientation, in reference
    order.  ``free_mask`` has the grid's shape."""
    g = as_grid(grid, device)
    for perm in orientations(geometry, tuple(g.shape)):
        yield perm, (window_sums(g.long(), perm) == 0).cpu().numpy()


def first_fits(grid: torch.Tensor, geometries: Sequence[Sequence[int]]) -> List[Optional[Tuple[Tuple[int, ...], Coord]]]:
    """:func:`first_fit` of each geometry on a grid tensor, with one host
    synchronisation for all of them."""
    dims = tuple(grid.shape)
    count_dispatch("first_fit", grid.device.type)
    per = [orientations(g, dims) for g in geometries]
    perms = [p for ps in per for p in ps]
    if not perms:
        return [None] * len(geometries)
    occ = grid.long()
    free = torch.stack([(window_sums(occ, p) == 0).reshape(-1) for p in perms])
    found = torch.stack([free.any(dim=1).long(), free.int().argmax(dim=1)]).cpu().numpy()
    out, i = [], 0
    for ps in per:
        hit = None
        for p in ps:
            if hit is None and found[0, i]:
                hit = (p, tuple(int(x) for x in np.unravel_index(int(found[1, i]), dims)))
            i += 1
        out.append(hit)
    return out


def first_fit(
    grid, geometry: Sequence[int], device: DeviceLike = "cuda"
) -> Optional[Tuple[Tuple[int, ...], Coord]]:
    """First free translate of any orientation — the reference scan's
    choice (orientation order, then C-order offsets), searched on
    ``device``."""
    return first_fits(as_grid(grid, device), [geometry])[0]


def placement_cells(dims: Sequence[int], oriented: Sequence[int], offset: Coord) -> Tuple[np.ndarray, ...]:
    """Open-mesh index (``np.ix_``) of the cells covered by the placement —
    usable directly for grid assignment and reads."""
    return np.ix_(*[(int(offset[k]) + np.arange(int(oriented[k]))) % int(a) for k, a in enumerate(dims)])


def cells_index(dims: Sequence[int], oriented: Sequence[int], offset: Coord, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """:func:`placement_cells` as broadcasting index tensors on ``device``."""
    return tuple(torch.from_numpy(ix).to(device) for ix in placement_cells(dims, oriented, offset))


# ---------------------------------------------------------------------------
# Traffic of a placement.
# ---------------------------------------------------------------------------
def _relative_cells(oriented: Tuple[int, ...]) -> np.ndarray:
    n = int(np.prod(oriented))
    return np.stack(np.unravel_index(np.arange(n), oriented), axis=1).astype(np.int64)


def placement_pairing_traffic(
    dims: Sequence[int], oriented: Sequence[int], offset: Coord
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The job's bisection-pairing traffic in machine coordinates: every
    cell sends unit volume to its cuboid-antipode (offset by ``oriented //
    2`` within the cuboid, wrapped cuboid-locally).  It cannot interfere
    across disjoint placements; use all-to-all for the cross-placement
    score."""
    dims = tuple(int(a) for a in dims)
    oriented = tuple(int(w) for w in oriented)
    rel = _relative_cells(oriented)
    half = np.asarray([w // 2 for w in oriented], dtype=np.int64)
    dst_rel = (rel + half) % np.asarray(oriented, dtype=np.int64)
    off = np.asarray(offset, dtype=np.int64)
    d = np.asarray(dims, dtype=np.int64)
    src = (rel + off) % d
    dst = (dst_rel + off) % d
    keep = ~(src == dst).all(axis=1)
    return src[keep], dst[keep], np.ones(int(keep.sum()), dtype=np.float64)


def placement_all_to_all_traffic(
    dims: Sequence[int], oriented: Sequence[int], offset: Coord
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Intra-job all-to-all in machine coordinates, volume ``1/n`` per
    ordered pair so every cell injects ~unit volume regardless of job size.

    This is the contention-scoring pattern: messages between cells at
    within-span distance beyond half the ring route the short way around —
    *through* foreign territory — so placements with long spans genuinely
    load links that other placements use.
    """
    dims = tuple(int(a) for a in dims)
    oriented = tuple(int(w) for w in oriented)
    n = int(np.prod(oriented))
    rel = _relative_cells(oriented)
    off = np.asarray(offset, dtype=np.int64)
    d = np.asarray(dims, dtype=np.int64)
    cells = (rel + off) % d
    si = np.repeat(np.arange(n), n)
    di = np.tile(np.arange(n), n)
    keep = si != di
    si, di = si[keep], di[keep]
    vol = np.full(si.shape[0], 1.0 / n, dtype=np.float64)
    return cells[si], cells[di], vol


def base_loads(dims: Sequence[int], oriented: Sequence[int], device: DeviceLike = "cuda") -> np.ndarray:
    """The job's all-to-all load field for a placement at the origin,
    routed by :func:`repro_torch.network.routing.route_dor` on ``device``.
    Loads translate with the placement, so this one field serves every
    offset of the orientation."""
    dims = tuple(int(a) for a in dims)
    src, dst, vol = placement_all_to_all_traffic(dims, oriented, (0,) * len(dims))
    if src.shape[0] == 0:
        resolve_device(device)
        return np.zeros((len(dims), 2) + dims)
    return route_dor(dims, src, dst, vol, device=device)


def _roll(field, offset: Coord, dims: Tuple[int, ...]):
    off = tuple(int(o) % a for o, a in zip(offset, dims))
    if not any(off):
        return field
    axes = tuple(range(2, 2 + len(dims)))
    if isinstance(field, torch.Tensor):
        return torch.roll(field, off, dims=axes)
    return np.roll(field, off, axis=axes)


def placement_loads(
    dims: Sequence[int],
    oriented: Sequence[int],
    offset: Coord,
    pattern: str = "all-to-all",
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Link loads of the placement's traffic on the machine torus:
    ``"all-to-all"`` (the cross-placement contention model, default, the
    origin field rolled to ``offset``) or ``"pairing"`` (the paper's
    intra-partition benchmark), routed on ``device``."""
    dims = tuple(int(a) for a in dims)
    if pattern == "all-to-all":
        return _roll(base_loads(dims, tuple(oriented), device=device), offset, dims)
    if pattern != "pairing":
        raise ValueError(f"unknown traffic pattern {pattern!r}")
    src, dst, vol = placement_pairing_traffic(dims, oriented, offset)
    if src.shape[0] == 0:
        resolve_device(device)
        return np.zeros((len(dims), 2) + dims)
    return route_dor(dims, src, dst, vol, device=device)


def shared_link_contention(job_loads: np.ndarray, background: np.ndarray) -> float:
    """Traffic volume the job routes over links already carrying neighbour
    traffic — the avoidable-interference proxy used for scoring."""
    return float(job_loads[background > 0.0].sum())


@dataclass(frozen=True)
class ScoredPlacement:
    """One scored candidate; :func:`best_placement` picks the minimum of
    (contention, -contact, orientation, offset)."""

    oriented: Tuple[int, ...]
    offset: Coord
    bisection: int  # of the canonical geometry (orientation-invariant)
    contact: int  # occupied cells touching the placement's shell
    contention: float  # job traffic on links shared with neighbours

    spilling: bool = False  # some span routes beyond its own cells


def is_spilling(oriented: Sequence[int], dims: Sequence[int]) -> bool:
    """Whether any span of the orientation routes all-to-all traffic outside
    its own cells: beyond half the ring (``2w - 2 > a``) and at exactly
    half (split ties send half that volume backward); a span covering the
    full ring never spills."""
    return any(2 * w - 2 >= a and w < a for w, a in zip(oriented, dims))


def fabric_can_interfere(dims: Sequence[int]) -> bool:
    """Whether any two *disjoint* cuboid placements can share a link: it
    needs a spilling span and a partner routing inside the spill corridor,
    which some span allows iff a ring has length >= 6.  Mira-class tori
    (rings <= 4) are contention-isolated; JUQUEEN's 7-ring is not."""
    return any(a >= 6 for a in dims)


# ---------------------------------------------------------------------------
# Integer-scaled load fields (exact, memoised per device).
# ---------------------------------------------------------------------------
@lru_cache(maxsize=512)
def _int_field(dims: Geometry, oriented: Tuple[int, ...], device: str) -> torch.Tensor:
    """The all-to-all field of a placement at the origin with volume 2 per
    ordered pair (whole messages 2 per link, split ties 1): an exact int64
    tensor on ``device``, built from chunks of :data:`PAIR_CHUNK` pairs.
    Cached; callers never write it."""
    dev = torch.device(device)
    n = int(np.prod(oriented))
    out = torch.zeros((len(dims), 2) + dims, dtype=torch.float64, device=dev)
    if n > 1:
        cells = torch.from_numpy(_relative_cells(oriented)).to(dev)
        rows = max(1, PAIR_CHUNK // n)
        count_dispatch("route_loads", dev.type)
        for lo in range(0, n, rows):
            si = torch.arange(lo, min(n, lo + rows), device=dev).repeat_interleave(n)
            di = torch.arange(n, device=dev).repeat(si.shape[0] // n)
            keep = si != di
            src, dst = cells[si[keep]], cells[di[keep]]
            # Integer partial sums: exact in any order and over chunks.
            out += backend._route_loads(dims, src, dst, torch.full((src.shape[0],), 2.0, dtype=torch.float64, device=dev), True)
    return torch.round(out).long()


def int_field(dims: Sequence[int], oriented: Sequence[int], device: torch.device) -> torch.Tensor:
    """:func:`int_base_loads` as the cached tensor on ``device`` (read it,
    never write it)."""
    return _int_field(tuple(int(a) for a in dims), tuple(int(w) for w in oriented), str(device))


def int_base_loads(dims: Sequence[int], oriented: Sequence[int], device: DeviceLike = "cuda") -> np.ndarray:
    """The placement's all-to-all load field at the origin, scaled by
    ``2 * n`` so every value is an exact int64:
    ``placement_loads(...) == int_base_loads(...) / (2 * n)`` up to one
    float rounding, with identical support.  A read-only array."""
    arr = int_field(dims, oriented, resolve_device(device)).cpu().numpy().copy()
    arr.setflags(write=False)
    return arr


def int_placement_loads(
    dims: Sequence[int], oriented: Sequence[int], offset: Coord, device: DeviceLike = "cuda"
) -> np.ndarray:
    """:func:`int_base_loads` translated to ``offset``."""
    dims = tuple(int(a) for a in dims)
    return _roll(int_base_loads(dims, oriented, device), offset, dims)


# ---------------------------------------------------------------------------
# The contention field and the scored search.
# ---------------------------------------------------------------------------
def interference_mask(grid, background_loads=None):
    """(D, 2, *dims) boolean mask of links a new job should avoid loading:
    links leaving an occupied cell, plus links already carrying background
    traffic.  NumPy in, NumPy out; tensors in, a tensor out."""
    if isinstance(grid, torch.Tensor):
        D = grid.ndim
        mask = grid.expand((D, 2) + tuple(grid.shape)).clone()
        if background_loads is not None:
            mask |= background_loads > 0.0
        return mask
    D = len(grid.shape)
    mask = np.broadcast_to(grid.astype(bool), (D, 2) + grid.shape).copy()
    if background_loads is not None:
        mask |= background_loads > 0.0
    return mask


def contention_field(
    dims: Sequence[int], oriented: Sequence[int], mask: np.ndarray, device: DeviceLike = "cuda"
) -> np.ndarray:
    """Predicted interference for every offset of an orientation: the job's
    traffic volume over masked links (:func:`interference_mask`),

        C[o] = sum_{k,d,v} J[k,d][(v - o) mod dims] * mask[k,d][v],

    one batched FFT cross-correlation on ``device``.  Values carry FFT
    round-off (~1e-12), as the JAX package's do; :func:`best_placement`
    ranks the snapped field instead (module docstring)."""
    dims = tuple(int(a) for a in dims)
    J = base_loads(dims, tuple(int(w) for w in oriented), device=device)
    return backend.contention_field(mask, J, device=device)


def best_placement(
    grid,
    geometry: Sequence[int],
    background_loads=None,
    device: DeviceLike = "cuda",
) -> Optional[ScoredPlacement]:
    """Scored placement of one geometry: among all free translates of all
    orientations, minimise predicted interference (the job's all-to-all
    traffic over links leaving occupied cells or already carrying the
    existing placements' traffic).  Ties break toward the snuggest
    candidate (max contact) on spill-free fabrics, then the reference scan
    order.  ``grid`` and ``background_loads`` may be NumPy or tensors;
    the search runs on ``device`` and synchronises once.

    With tracing enabled the search records a ``placement.search`` span
    annotated with the winner; the choice is identical either way.
    """
    dev = resolve_device(device)
    if not _TRACER.enabled:
        return _best_placement_impl(grid, geometry, background_loads, dev)
    with _TRACER.span("placement.search", geometry=tuple(int(g) for g in geometry)) as span:
        out = _best_placement_impl(grid, geometry, background_loads, dev)
        if out is not None:
            span.annotate(oriented=out.oriented, offset=out.offset, contention=out.contention)
        else:
            span.annotate(placed=False)
        return out


def _best_placement_impl(grid, geometry, background_loads, dev: torch.device) -> Optional[ScoredPlacement]:
    g = as_grid(grid, dev)
    dims = tuple(g.shape)
    bis = bisection_links(pad_geometry(geometry, len(dims)))
    perms = orientations(geometry, dims)
    if not perms:
        return None
    count_dispatch("placement_search", dev.type)
    bg = background_loads
    if bg is not None and not isinstance(bg, torch.Tensor):
        bg = torch.from_numpy(np.array(bg, dtype=np.float64)).to(dev)
    fm = backend.mask_fft(interference_mask(g, bg))
    occ = g.long()
    # Snug (max-contact) tie-breaking keeps the free set contiguous, but
    # where placements can share links it steers later jobs through their
    # neighbours; it is enabled exactly on interference-free fabrics.
    use_contact = not fabric_can_interfere(dims)
    rows, gap = [], torch.zeros((), dtype=torch.float64, device=dev)
    for perm in perms:
        free = (window_sums(occ, perm) == 0).reshape(-1)
        contact = contact_sums(occ, perm).reshape(-1)
        snapped, err = backend.snapped_contention(fm, int_field(dims, perm, dev))
        snapped = snapped.reshape(-1)
        gap = torch.maximum(gap, err)
        # Within the orientation: argmin over (contention rounded to 9
        # decimals, -contact, C-order offset), as np.lexsort takes it.
        key = torch.where(free, torch.round(snapped / (2.0 * int(np.prod(perm))), decimals=9), torch.inf)
        best = key == key.min()
        rank = contact if use_contact else torch.zeros_like(contact)
        rank = torch.where(best, rank, -1)
        i = (best & (rank == rank.max())).int().argmax()
        rows.append(torch.stack([free.any().double(), i.double(), contact[i].double(), snapped[i]]))
    host = torch.cat([torch.stack(rows).reshape(-1), gap.reshape(1)]).cpu().numpy()
    if host[-1] > SNAP_TOLERANCE:
        raise RuntimeError(f"contention field lost its integer: FFT value {host[-1]} from it")
    chosen: Optional[Tuple[tuple, ScoredPlacement]] = None
    for perm, (has_free, flat, contact, snapped) in zip(perms, host[:-1].reshape(-1, 4)):
        if not has_free:
            continue
        offset = tuple(int(x) for x in np.unravel_index(int(flat), dims))
        # The exact value, rounded as the JAX package reports its own.
        contention = round(float(snapped) / (2 * int(np.prod(perm))), 9)
        key = (contention, -int(contact) if use_contact else 0, perm, offset)
        if chosen is None or key < chosen[0]:
            chosen = (
                key,
                ScoredPlacement(
                    oriented=perm,
                    offset=offset,
                    bisection=bis,
                    contact=int(contact),
                    contention=contention,
                    spilling=is_spilling(perm, dims),
                ),
            )
    return chosen[1] if chosen else None
