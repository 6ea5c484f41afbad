"""Topology-aware rank mapping inside a placement (port of
``repro.network.mapping``).

A mapping is an (n, D) int array of machine-torus coordinates, one row per
rank; traffic is rank-space ``(src_rank, dst_rank, vol)``.  A mapping's
**congestion** is the max per-physical-link load of its traffic routed by
DOR on the machine torus (double links halve under the BG/Q convention),
its **dilation** the volume-weighted hop count; candidates rank
lexicographically, congestion first.

:func:`map_ranks` scores its whole strategy catalogue — ``identity``,
every ``axis-permutation`` (axis orders x reversals, unit dims
deduplicated), ``gray-snake`` — in one
:func:`repro_torch.network.backend.score_candidates` call on ``device``
(in chunks under its memory budget; the scores are row-exact, so the
chunking cannot change the winner), then refines the winner with
:func:`greedy_refine`, whose swap trials route on ``device`` and come back
to the host once per round.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network import patterns
from repro_torch.network.backend import _route_loads, _tensor, max_load_t, score_candidates
from repro_torch.network.geometry import volume
from repro_torch.network.routing import route_dor

Coord = Tuple[int, ...]
RankTraffic = Tuple[np.ndarray, np.ndarray, np.ndarray]

#: Patterns understood by :func:`pattern_traffic`, in rank space.
MAPPING_PATTERNS = ("halo", "pairing", "ring", "all-to-all")

__all__ = [
    "MAPPING_PATTERNS",
    "MappingScore",
    "RankMapping",
    "axis_order_coords",
    "axis_permutation_orders",
    "greedy_refine",
    "identity_mapping",
    "map_ranks",
    "mapping_loads",
    "mapping_traffic",
    "mesh_axis_hops",
    "pattern_traffic",
    "placement_cell_coords",
    "score_mapping",
    "snake_mapping",
    "toroidal_hops",
]


def pattern_traffic(
    logical_dims: Sequence[int], pattern: str = "halo", vol: float = 1.0
) -> RankTraffic:
    """Named workload on the logical process grid, in rank space.

    ``(src_rank, dst_rank, vol)`` with ranks raveled row-major over
    ``logical_dims``.  Patterns: ``"halo"`` (nearest-neighbour exchange on
    the logical grid), ``"pairing"`` (the paper's antipodal benchmark),
    ``"ring"`` (each rank exchanges with rank +-1 mod n — ring-collective
    step traffic, defined on rank order, not logical coordinates), and
    ``"all-to-all"`` (mapping-invariant by construction; useful as a
    sanity control).  Volumes are uniform, ``vol`` per message.
    """
    logical_dims = tuple(int(a) for a in logical_dims)
    n = volume(logical_dims)
    if pattern == "ring":
        if n <= 1:
            empty = np.zeros(0, dtype=np.int64)
            return empty, empty.copy(), np.zeros(0)
        r = np.arange(n, dtype=np.int64)
        src = np.concatenate([r, r])
        dst = np.concatenate([(r + 1) % n, (r - 1) % n])
        return src, dst, np.full(2 * n, float(vol))
    by_name = {
        "halo": patterns.nearest_neighbor_halo,
        "pairing": patterns.bisection_pairing,
        "all-to-all": patterns.all_to_all,
    }
    if pattern not in by_name:
        raise ValueError(
            f"unknown mapping pattern {pattern!r}; expected one of {MAPPING_PATTERNS}"
        )
    s, d, v = by_name[pattern](logical_dims, vol)
    if s.shape[0] == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.copy(), np.zeros(0)
    src = np.ravel_multi_index(tuple(s.T), logical_dims).astype(np.int64)
    dst = np.ravel_multi_index(tuple(d.T), logical_dims).astype(np.int64)
    return src, dst, np.asarray(v, dtype=np.float64)


@dataclass(frozen=True)
class MappingScore:
    """(congestion, dilation) of one mapping under one traffic pattern.

    ``congestion`` — max per-physical-link load (the phase-time bound,
    in traffic-volume units; BG/Q double links halve).  ``dilation`` —
    total volume-weighted hop count over all messages.
    """

    congestion: float
    dilation: float

    def key(self) -> Tuple[float, float]:
        """Lexicographic ranking key, rounded so float noise cannot flip
        the congestion-first comparison (mirrors placement scoring)."""
        return (round(self.congestion, 9), round(self.dilation, 9))


def toroidal_hops(
    dims: Sequence[int],
    src: np.ndarray,
    dst: np.ndarray,
    wrap: Optional[Sequence[bool]] = None,
) -> np.ndarray:
    """Minimal hop count per message: wrap-aware Manhattan distance —
    exactly the links a minimal DOR route traverses on the torus; an
    unwrapped dimension (``wrap``) contributes the plain chain distance."""
    d = np.asarray(tuple(int(a) for a in dims), dtype=np.int64)
    delta = np.abs(np.atleast_2d(src) - np.atleast_2d(dst))
    around = np.minimum(delta, d - delta)
    if wrap is not None:
        w = np.asarray(tuple(bool(x) for x in wrap), dtype=bool)
        around = np.where(w, around, delta)
    return around.sum(axis=1)


def mapping_traffic(coords: np.ndarray, traffic: RankTraffic) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank-space traffic translated into machine coordinates by a mapping:
    ``(coords[src_rank], coords[dst_rank], vol)``."""
    rsrc, rdst, vol = traffic
    if rsrc.shape[0] == 0:
        empty = np.zeros((0, coords.shape[1]), dtype=np.int64)
        return empty, empty.copy(), np.zeros(0)
    return coords[rsrc], coords[rdst], np.asarray(vol, dtype=np.float64)


def mapping_loads(
    dims: Sequence[int],
    coords: np.ndarray,
    traffic: RankTraffic,
    split_ties: bool = True,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """(D, 2, *dims) link-load tensor of the mapped rank traffic on the
    machine torus, routed on ``device``."""
    dims = tuple(int(a) for a in dims)
    rsrc, rdst, vol = traffic
    if rsrc.shape[0] == 0:
        resolve_device(device)
        return np.zeros((len(dims), 2) + dims)
    return route_dor(dims, coords[rsrc], coords[rdst], vol, split_ties=split_ties, device=device)


def score_mapping(
    dims: Sequence[int],
    coords: np.ndarray,
    traffic: RankTraffic,
    split_ties: bool = True,
    double_link_on_2: bool = True,
    device: DeviceLike = "cuda",
) -> MappingScore:
    """Score one mapping: route the rank traffic on the machine torus and
    reduce to (congestion, dilation), on ``device``.  Equal to the JAX
    package's ``score_mapping`` for integer or dyadic volumes."""
    cong, dil = score_candidates(
        dims, np.asarray(coords)[None], traffic, split_ties, double_link_on_2, device=device
    )
    return MappingScore(float(cong[0]), float(dil[0]))


# ---------------------------------------------------------------------------
# Cell enumerations (the structured strategies).
# ---------------------------------------------------------------------------
def placement_cell_coords(dims: Sequence[int], oriented: Sequence[int], offset: Coord) -> np.ndarray:
    """(n, D) machine coordinates of the placement's cells in row-major
    (C) order over ``oriented`` — the identity mapping's coords."""
    dims = tuple(int(a) for a in dims)
    oriented = tuple(int(w) for w in oriented)
    n = volume(oriented)
    rel = np.stack(np.unravel_index(np.arange(n), oriented), axis=1).astype(np.int64)
    off = np.asarray(offset, dtype=np.int64)
    return (rel + off) % np.asarray(dims, dtype=np.int64)


def identity_mapping(dims: Sequence[int], oriented: Sequence[int], offset: Coord) -> np.ndarray:
    """Row-major rank order over the oriented cuboid — the baseline."""
    return placement_cell_coords(dims, oriented, offset)


def axis_permutation_orders(oriented: Sequence[int]) -> Iterator[Tuple[Tuple[int, ...], Tuple[bool, ...]]]:
    """All distinct (axis order, per-axis reversal) enumerations of the
    cuboid, deduplicated: unit dims neither reorder nor reverse, so a
    (1, 4, 1) cuboid yields exactly 2 candidates, not 48."""
    oriented = tuple(int(w) for w in oriented)
    D = len(oriented)
    seen = set()
    for perm in itertools.permutations(range(D)):
        for rev in itertools.product((False, True), repeat=D):
            key = tuple((p, rev[p]) for p in perm if oriented[p] > 1)
            if key in seen:
                continue
            seen.add(key)
            yield perm, rev


def axis_order_coords(
    dims: Sequence[int],
    oriented: Sequence[int],
    offset: Coord,
    perm: Sequence[int],
    reverse: Sequence[bool],
) -> np.ndarray:
    """Cells enumerated with axis ``perm[0]`` slowest / ``perm[-1]``
    fastest, axis k reversed where ``reverse[k]``; rank r gets the r-th
    cell.  ``perm = (0, 1, ..)`` with no reversal is the identity."""
    dims = tuple(int(a) for a in dims)
    oriented = tuple(int(w) for w in oriented)
    n = volume(oriented)
    shape = tuple(oriented[p] for p in perm)
    in_perm = np.stack(np.unravel_index(np.arange(n), shape), axis=1).astype(np.int64)
    rel = np.empty((n, len(dims)), dtype=np.int64)
    for i, p in enumerate(perm):
        c = in_perm[:, i]
        if reverse[p]:
            c = oriented[p] - 1 - c
        rel[:, p] = c
    off = np.asarray(offset, dtype=np.int64)
    return (rel + off) % np.asarray(dims, dtype=np.int64)


def snake_mapping(dims: Sequence[int], oriented: Sequence[int], offset: Coord) -> np.ndarray:
    """Boustrophedon (reflected-Gray-code) cell order: consecutive ranks
    always occupy physically adjacent cells — a Hamiltonian path through
    the cuboid, the right enumeration for ring collectives without wrap."""
    dims = tuple(int(a) for a in dims)
    oriented = tuple(int(w) for w in oriented)
    n = volume(oriented)
    rel = np.stack(np.unravel_index(np.arange(n), oriented), axis=1).astype(np.int64)
    out = rel.copy()
    parity = np.zeros(n, dtype=np.int64)
    for k, w in enumerate(oriented):
        flip = parity % 2 == 1
        out[:, k] = np.where(flip, w - 1 - rel[:, k], rel[:, k])
        parity = parity + out[:, k]
    off = np.asarray(offset, dtype=np.int64)
    return (out + off) % np.asarray(dims, dtype=np.int64)


# ---------------------------------------------------------------------------
# Greedy congestion refinement.
# ---------------------------------------------------------------------------
def greedy_refine(
    dims: Sequence[int],
    coords: np.ndarray,
    traffic: RankTraffic,
    split_ties: bool = True,
    double_link_on_2: bool = True,
    max_rounds: int = 3,
    max_ranks: int = 12,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, MappingScore, bool]:
    """Steepest-descent rank-swap refinement of a seed mapping.

    Per round: take the ``max_ranks`` ranks with the largest
    volume-weighted incident hop count, try every unordered swap among
    them, and apply the single best swap that lexicographically lowers
    (congestion, dilation).  The load tensor stays on ``device``; every
    trial delta-updates it (only the swapped ranks' incident messages are
    re-routed, all trials of a round as lanes of one routing pass), and
    the trials' congestions come to the host together, once per round;
    the choice among them is the JAX package's.  Deterministic; returns
    ``(coords, score, improved)``."""
    dev = resolve_device(device)
    dims = tuple(int(a) for a in dims)
    rsrc, rdst, vol = traffic
    coords = np.array(coords, dtype=np.int64)
    if rsrc.shape[0] == 0 or coords.shape[0] < 2:
        return coords, score_mapping(dims, coords, traffic, split_ties, double_link_on_2, device=dev), False

    vol = np.asarray(vol, dtype=np.float64)
    loads = _route_loads(dims, _tensor(coords[rsrc], dev), _tensor(coords[rdst], dev), _tensor(vol, dev), split_ties)
    hops = toroidal_hops(dims, coords[rsrc], coords[rdst])
    score = MappingScore(float(max_load_t(dims, loads, double_link_on_2)), float((vol * hops).sum()))

    n = coords.shape[0]
    improved_any = False
    for _ in range(max_rounds):
        # Heaviest communicators: volume-weighted incident hops per rank.
        whops = vol * toroidal_hops(dims, coords[rsrc], coords[rdst])
        per_rank = np.bincount(rsrc, weights=whops, minlength=n) + np.bincount(rdst, weights=whops, minlength=n)
        cand = np.argsort(-per_rank, kind="stable")[: min(max_ranks, n)]
        trials = []  # (incident messages, swapped coords)
        for i, j in itertools.combinations(sorted(int(c) for c in cand), 2):
            inc = (rsrc == i) | (rdst == i) | (rsrc == j) | (rdst == j)
            if not inc.any():
                continue
            swapped = coords.copy()
            swapped[[i, j]] = swapped[[j, i]]
            trials.append((inc, swapped))
        if not trials:
            break
        trial_loads = _swap_trials(dims, loads, coords, trials, traffic, split_ties, dev)
        congestion = max_load_t(dims, trial_loads, double_link_on_2).cpu().numpy()
        best_swap = None
        for t, ((inc, swapped), cong) in enumerate(zip(trials, congestion)):
            trial = MappingScore(
                float(cong),
                score.dilation
                - float((vol[inc] * toroidal_hops(dims, coords[rsrc[inc]], coords[rdst[inc]])).sum())
                + float((vol[inc] * toroidal_hops(dims, swapped[rsrc[inc]], swapped[rdst[inc]])).sum()),
            )
            if trial.key() < score.key() and (best_swap is None or trial.key() < best_swap[0].key()):
                best_swap = (trial, swapped, t)
        if best_swap is None:
            break
        score, coords, t = best_swap
        loads = trial_loads[t]
        improved_any = True
    # Re-score from scratch: the delta-updated tensor carries float noise.
    final = score_mapping(dims, coords, traffic, split_ties, double_link_on_2, device=dev)
    return coords, final, improved_any


def _swap_trials(dims, loads, coords, trials, traffic, split_ties, dev) -> torch.Tensor:
    """``max(loads - old + new, 0)`` of every swap trial, as lanes: each
    trial's incident messages routed before (``old``) and after (``new``)
    its swap, padded with zero-volume messages to one length."""
    rsrc, rdst, vol = traffic
    width = max(int(inc.sum()) for inc, _ in trials)
    T, D = len(trials), len(dims)
    ends = np.zeros((2, 2, T, width, D), dtype=np.int64)  # (old/new, src/dst, lane, message, dim)
    vols = np.zeros((T, width))
    for t, (inc, swapped) in enumerate(trials):
        m = int(inc.sum())
        for side, c in enumerate((coords, swapped)):
            ends[side, 0, t, :m] = c[rsrc[inc]]
            ends[side, 1, t, :m] = c[rdst[inc]]
        vols[t, :m] = np.asarray(vol, dtype=np.float64)[inc]
    e, v = _tensor(ends, dev), _tensor(vols, dev)
    old = _route_loads(dims, e[0, 0], e[0, 1], v, split_ties)
    new = _route_loads(dims, e[1, 0], e[1, 1], v, split_ties)
    return torch.clamp(loads - old + new, min=0.0)


# ---------------------------------------------------------------------------
# The engine's front door.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RankMapping:
    """A chosen rank->cell embedding and its predicted cost.

    ``coords[r]`` is the machine-torus coordinate of rank r;
    ``logical_dims`` the logical process grid (ranks raveled row-major
    over it); ``score`` the winning strategy's (congestion, dilation) and
    ``identity_score`` the row-major baseline's.  ``wrap`` records the
    physical wrap-around links per machine dimension (None = all; the
    scores always model the fully-wrapped torus), ``loads`` the chosen
    mapping's link-load tensor (write-locked) and ``rank_traffic`` the
    scored rank-space traffic.
    """

    dims: Tuple[int, ...]
    oriented: Tuple[int, ...]
    offset: Coord
    logical_dims: Tuple[int, ...]
    pattern: str
    strategy: str
    coords: np.ndarray
    score: MappingScore
    identity_score: MappingScore
    wrap: Optional[Tuple[bool, ...]] = None
    loads: Optional[np.ndarray] = None
    rank_traffic: Optional[RankTraffic] = None

    @property
    def num_ranks(self) -> int:
        """Number of ranks (== cells of the placement)."""
        return int(self.coords.shape[0])

    def machine_traffic(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The mapping's scored traffic as machine-coordinate messages
        (``src, dst, vol``), ready for the flow simulator."""
        if self.rank_traffic is None:
            empty = np.zeros((0, len(self.dims)), dtype=np.int64)
            return empty, empty.copy(), np.zeros(0)
        return mapping_traffic(self.coords, self.rank_traffic)

    @property
    def recovered_congestion(self) -> float:
        """Max-link-load reduction vs the row-major baseline (>= 0)."""
        return self.identity_score.congestion - self.score.congestion

    def cell_of_rank(self, rank: int) -> Coord:
        """Machine coordinate of one rank."""
        return tuple(int(x) for x in self.coords[rank])


def map_ranks(
    dims: Sequence[int],
    oriented: Sequence[int],
    offset: Optional[Coord] = None,
    logical_dims: Optional[Sequence[int]] = None,
    pattern: str = "halo",
    traffic: Optional[RankTraffic] = None,
    split_ties: bool = True,
    double_link_on_2: bool = True,
    refine: bool = True,
    wrap: Optional[Sequence[bool]] = None,
    device: DeviceLike = "cuda",
) -> RankMapping:
    """Choose the best rank->cell embedding for a placed cuboid.

    Scores the full strategy catalogue — row-major ``identity``,
    ``axis-permutation`` and ``gray-snake`` — in one batched
    :func:`repro_torch.network.backend.score_candidates` call on
    ``device``, takes the lexicographic (congestion, dilation) winner
    (earlier strategies win ties, so identity wins unless something
    strictly helps) and, with ``refine=True``, a ``greedy`` refinement of
    it when that is strictly better.  ``logical_dims`` is the job's
    logical process grid (default: the oriented extents); ``traffic``
    overrides ``pattern`` with explicit rank-space arrays; ``wrap`` is
    recorded for :func:`mesh_axis_hops`.

    >>> m = map_ranks((4, 8), (2, 8), (0, 0), logical_dims=(8, 2), pattern="halo", device="cpu")
    >>> m.identity_score.congestion, m.score.congestion
    (4.0, 2.0)
    >>> m.strategy
    'axis-permutation'
    """
    dev = resolve_device(device)
    dims = tuple(int(a) for a in dims)
    oriented = tuple(int(w) for w in oriented)
    if offset is None:
        offset = (0,) * len(dims)
    offset = tuple(int(o) for o in offset)
    if len(oriented) != len(dims) or any(w < 1 or w > a for w, a in zip(oriented, dims)):
        raise ValueError(f"orientation {oriented} does not fit machine {dims}")
    logical = tuple(int(a) for a in logical_dims) if logical_dims is not None else oriented
    if volume(logical) != volume(oriented):
        raise ValueError(
            f"logical grid {logical} has {volume(logical)} ranks; placement "
            f"{oriented} has {volume(oriented)} cells"
        )
    if traffic is None:
        traffic = pattern_traffic(logical, pattern)
    else:
        pattern = "explicit"

    cand_list: List[Tuple[str, np.ndarray]] = [("identity", identity_mapping(dims, oriented, offset))]
    for perm, rev in axis_permutation_orders(oriented):
        if all(p == i for i, p in enumerate(perm)) and not any(rev):
            continue  # the identity enumeration, already scored
        cand_list.append(("axis-permutation", axis_order_coords(dims, oriented, offset, perm, rev)))
    cand_list.append(("gray-snake", snake_mapping(dims, oriented, offset)))

    cong, dil = score_candidates(
        dims, np.stack([c for _, c in cand_list]), traffic, split_ties, double_link_on_2, device=dev
    )
    candidates = [(name, c, MappingScore(float(cg), float(dl))) for (name, c), cg, dl in zip(cand_list, cong, dil)]
    identity_score = candidates[0][2]

    strategy, coords, score = min(candidates, key=lambda t: t[2].key())
    if refine:
        refined, rscore, improved = greedy_refine(dims, coords, traffic, split_ties, double_link_on_2, device=dev)
        if improved and rscore.key() < score.key():
            strategy, coords, score = f"greedy({strategy})", refined, rscore
    coords = np.ascontiguousarray(coords)
    coords.setflags(write=False)
    loads = mapping_loads(dims, coords, traffic, split_ties, device=dev)
    loads.setflags(write=False)
    return RankMapping(
        dims=dims,
        oriented=oriented,
        offset=offset,
        logical_dims=logical,
        pattern=pattern,
        strategy=strategy,
        coords=coords,
        score=score,
        identity_score=identity_score,
        wrap=tuple(bool(x) for x in wrap) if wrap is not None else None,
        loads=loads,
        rank_traffic=traffic,
    )


# ---------------------------------------------------------------------------
# Mesh-axis measurement.
# ---------------------------------------------------------------------------
def mesh_axis_hops(
    dims: Sequence[int],
    coords: np.ndarray,
    mesh_shape: Sequence[int],
    axis: int,
    wrap: Optional[Sequence[bool]] = None,
) -> Tuple[int, int]:
    """Measured neighbour distances of one logical mesh axis under a
    mapping: ``(interior, wrap)`` — the max hop count between
    consecutive-rank pairs along the axis, and between its last and first
    rank.  Ranks are raveled row-major over ``mesh_shape``; a size-1 axis
    measures ``(0, 0)``; distances never use a missing wrap link."""
    dims = tuple(int(a) for a in dims)
    shape = tuple(int(s) for s in mesh_shape)
    n = int(np.prod(shape))
    if coords.shape[0] != n:
        raise ValueError(f"mapping has {coords.shape[0]} ranks; mesh {shape} needs {n}")
    size = shape[axis]
    if size <= 1:
        return 0, 0
    stride = int(np.prod(shape[axis + 1:])) if axis + 1 < len(shape) else 1
    idx = np.arange(n)
    coord_k = (idx // stride) % size
    interior = idx[coord_k < size - 1]
    wrap_src = idx[coord_k == size - 1]
    interior_max = int(toroidal_hops(dims, coords[interior], coords[interior + stride], wrap).max())
    wrap_max = int(toroidal_hops(dims, coords[wrap_src], coords[wrap_src - (size - 1) * stride], wrap).max())
    return interior_max, wrap_max
