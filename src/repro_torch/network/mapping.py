"""Rank-mapping scores (port of the scoring part of
``repro.network.mapping``).

A mapping is an (n, D) int array of machine-torus coordinates, one row per
rank; traffic is rank-space ``(src_rank, dst_rank, vol)``.  A mapping's
**congestion** is the max per-physical-link load of its traffic routed by
DOR on the machine torus (double links halve under the BG/Q convention),
its **dilation** the volume-weighted hop count.  :func:`score_mapping` is
:func:`repro_torch.network.backend.score_candidates` at one candidate.
The strategy catalogue (``map_ranks``, ``greedy_refine``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.network import patterns
from repro_torch.network.backend import score_candidates
from repro_torch.network.geometry import volume

RankTraffic = Tuple[np.ndarray, np.ndarray, np.ndarray]

#: Patterns understood by :func:`pattern_traffic`, in rank space.
MAPPING_PATTERNS = ("halo", "pairing", "ring", "all-to-all")

__all__ = ["MAPPING_PATTERNS", "MappingScore", "pattern_traffic", "score_mapping"]


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
