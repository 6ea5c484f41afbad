"""Traffic-pattern library for the routing engine (a copy of
``repro.network.patterns``; the port imports nothing of ``repro``).

Each pattern returns ``(src, dst, vol)`` — integer arrays of shape (M, D)
and a float array of shape (M,) — ready to feed
:func:`repro_torch.network.routing.route_dor`.  The
patterns cover the paper's benchmark (bisection pairing) plus the standard
workloads used for policy evaluation: all-to-all, nearest-neighbour halo
exchange, ring collectives (neighbour shifts), random permutations, and
transpose/shift patterns.

All are fully vectorized; none enumerate vertices in Python loops.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

Coord = Tuple[int, ...]
Traffic = Tuple[np.ndarray, np.ndarray, np.ndarray]


def vertices(dims: Sequence[int]) -> np.ndarray:
    """All vertex coordinates as an (N, D) int array (C order)."""
    dims = tuple(int(a) for a in dims)
    n = int(np.prod(dims))
    idx = np.arange(n)
    return np.stack(np.unravel_index(idx, dims), axis=1).astype(np.int64)


def _traffic(src: np.ndarray, dst: np.ndarray, vol) -> Traffic:
    vol = np.broadcast_to(np.asarray(vol, dtype=np.float64), (src.shape[0],))
    return src, dst, np.array(vol)


# ---------------------------------------------------------------------------
# Offsets and shifts.
# ---------------------------------------------------------------------------
def furthest_offset(dims: Sequence[int]) -> Tuple[int, ...]:
    """The maximal-hop-distance offset (pairs each node with its antipode)."""
    return tuple(a // 2 for a in dims)


def uniform_shift(dims: Sequence[int], offset: Sequence[int], vol: float = 1.0) -> Traffic:
    """Every vertex sends vol to vertex + offset (translation invariant)."""
    dims = tuple(int(a) for a in dims)
    v = vertices(dims)
    off = np.asarray(offset, dtype=np.int64)
    dst = (v + off) % np.asarray(dims, dtype=np.int64)
    return _traffic(v, dst, vol)


def ring_shift(dims: Sequence[int], axis: int, steps: int = 1, vol: float = 1.0) -> Traffic:
    """Neighbour shift along one axis — the collective-permute / ring-matmul
    step pattern (one hop per logical step when ``steps == 1``)."""
    off = [0] * len(tuple(dims))
    off[axis] = steps
    return uniform_shift(dims, off, vol)


# ---------------------------------------------------------------------------
# Paper experiment A: the bisection-pairing benchmark.
# ---------------------------------------------------------------------------
def pairing_pairs(dims: Sequence[int]) -> List[Tuple[Coord, Coord]]:
    """Explicit furthest-node pairing (each unordered pair listed once)."""
    dims = tuple(dims)
    off = furthest_offset(dims)
    pairs = []
    seen = set()
    for v in itertools.product(*(range(a) for a in dims)):
        w = tuple((v[k] + off[k]) % a for k, a in enumerate(dims))
        key = frozenset((v, w))
        if key in seen:
            continue
        seen.add(key)
        pairs.append((v, w))
    return pairs


def bisection_pairing(dims: Sequence[int], vol: float = 1.0) -> Traffic:
    """Every node exchanges vol with its antipode (both directions).

    This is the paper's contention benchmark: the full antipodal shift is a
    translation-invariant pattern, so the traffic is simply the furthest
    offset applied to every vertex — each unordered pair appears once per
    direction.
    """
    return uniform_shift(dims, furthest_offset(dims), vol)


# ---------------------------------------------------------------------------
# Dense patterns.
# ---------------------------------------------------------------------------
def all_to_all(
    dims: Sequence[int], vol_per_pair: float = 1.0, include_self: bool = False
) -> Traffic:
    """Every ordered vertex pair exchanges vol_per_pair."""
    v = vertices(dims)
    n = v.shape[0]
    si = np.repeat(np.arange(n), n)
    di = np.tile(np.arange(n), n)
    if not include_self:
        keep = si != di
        si, di = si[keep], di[keep]
    return _traffic(v[si], v[di], vol_per_pair)


def nearest_neighbor_halo(dims: Sequence[int], vol: float = 1.0) -> Traffic:
    """Halo exchange: every vertex sends vol to its +1 and -1 neighbour in
    every dimension of length > 1 (stencil / spatial-decomposition traffic).

    On a length-2 dimension the two neighbours coincide; both messages are
    kept, matching the two faces a halo exchange actually transmits.
    """
    dims = tuple(int(a) for a in dims)
    srcs, dsts = [], []
    for k, a in enumerate(dims):
        if a == 1:
            continue
        for step in (+1, -1):
            s, d, _ = ring_shift(dims, k, step, vol)
            srcs.append(s)
            dsts.append(d)
    if not srcs:
        empty = np.zeros((0, len(dims)), dtype=np.int64)
        return empty, empty.copy(), np.zeros(0)
    return _traffic(np.concatenate(srcs), np.concatenate(dsts), vol)


def random_permutation(
    dims: Sequence[int], vol: float = 1.0, seed: Optional[int] = None
) -> Traffic:
    """Each vertex sends vol to a distinct random destination (a permutation
    of the vertex set) — the classic adversarial-average routing workload."""
    v = vertices(dims)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(v.shape[0])
    return _traffic(v, v[perm], vol)


def transpose(dims: Sequence[int], vol: float = 1.0) -> Traffic:
    """2D matrix-transpose traffic: (x, y) -> (y, x) on a square 2D torus
    (higher dims must pair off equal lengths; the first two axes swap)."""
    dims = tuple(int(a) for a in dims)
    if len(dims) < 2 or dims[0] != dims[1]:
        raise ValueError(f"transpose needs the first two dims equal, got {dims}")
    v = vertices(dims)
    dst = v.copy()
    dst[:, 0], dst[:, 1] = v[:, 1], v[:, 0]
    keep = ~(v == dst).all(axis=1)
    return _traffic(v[keep], dst[keep], vol)


# ---------------------------------------------------------------------------
# Ring collectives as explicit traffic.
# ---------------------------------------------------------------------------
def ring_all_reduce_phases(
    dims: Sequence[int], axis: int, bytes_in: float
) -> List[Traffic]:
    """Bidirectional ring all-reduce over one physical axis as its
    ``2(n-1)`` dependent phases (reduce-scatter then all-gather).

    Each phase is one neighbour-shift step: every chip forwards half of a
    ``bytes_in / n`` shard to each ring direction.  Feeding the list to
    ``repro.network.netsim.simulate_phases`` cross-checks the closed
    form ``repro.network.collectives.ring_all_reduce_time``
    dynamically (the phases share one traffic tuple — treat it as
    read-only).
    """
    dims = tuple(int(a) for a in dims)
    n = dims[axis]
    if n <= 1:
        return []
    shard = bytes_in / n
    s1, d1, v1 = ring_shift(dims, axis, +1, shard / 2.0)
    s2, d2, v2 = ring_shift(dims, axis, -1, shard / 2.0)
    phase = (
        np.concatenate([s1, s2]),
        np.concatenate([d1, d2]),
        np.concatenate([v1, v2]),
    )
    return [phase] * (2 * (n - 1))


def hotspot_line(dims: Sequence[int], axis: int = 0, vol: float = 1.0) -> Traffic:
    """A deliberately skewed two-class workload for routing studies.

    The vertices of one line (all coordinates 0 except ``axis``) run a
    ring shift among themselves *and* send the same shift to the parallel
    line halfway across the next non-trivial dimension.  Dimension-ordered
    routing stacks both classes on the hotspot line's links; a least-loaded
    dimension order routes the second class around them — the pattern where
    ``repro.network.netsim.compare_routing`` shows what adaptive routing
    *can* recover (unlike the geometry-induced contention of balanced
    patterns, where it recovers nothing).
    """
    dims = tuple(int(a) for a in dims)
    a = dims[axis]
    partner = next(
        (k for k in range(len(dims)) if k != axis and dims[k] > 1), None
    )
    if a < 4 or partner is None:
        raise ValueError(
            f"hotspot_line needs dims[{axis}] >= 4 and a second non-trivial "
            f"dimension, got {dims}"
        )
    shift = max(1, a // 2 - 1)  # long but tie-free shift along the line
    line = np.zeros((a, len(dims)), dtype=np.int64)
    line[:, axis] = np.arange(a)
    near = line.copy()
    near[:, axis] = (np.arange(a) + shift) % a
    far = near.copy()
    far[:, partner] = dims[partner] // 2
    src = np.concatenate([line, line])
    dst = np.concatenate([near, far])
    return _traffic(src, dst, vol)


def ring_all_gather(dims: Sequence[int], axis: int, bytes_out: float) -> Traffic:
    """Bidirectional ring all-gather over one physical axis, expressed as the
    total per-step neighbour traffic: each chip forwards (n-1)/n of the
    result, split across both directions.

    This is the traffic-level counterpart of
    ``repro.network.collectives.ring_all_gather_time``; routing it
    through the engine reproduces the closed-form link load.
    """
    dims = tuple(int(a) for a in dims)
    n = dims[axis]
    if n <= 1:
        empty = np.zeros((0, len(dims)), dtype=np.int64)
        return empty, empty.copy(), np.zeros(0)
    shard = bytes_out / n
    per_dir = shard * (n - 1) / 2.0
    s1, d1, v1 = ring_shift(dims, axis, +1, per_dir)
    s2, d2, v2 = ring_shift(dims, axis, -1, per_dir)
    return (
        np.concatenate([s1, s2]),
        np.concatenate([d1, d2]),
        np.concatenate([v1, v2]),
    )
