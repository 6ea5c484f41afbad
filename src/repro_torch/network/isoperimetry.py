"""Batched exact cuboid cuts on a torus (port of the torus branch of
``repro.network.isoperimetry.cut_table``).

For a volume ``t`` the host enumerates every aligned side assignment
(divisor meshgrid), :func:`repro_torch.network.backend.cut_scores`
evaluates the closed-form cut of each on ``device`` in int64, and the host
groups the assignments by canonical geometry and keeps each one's minimum,
as the JAX package does.  The HyperX branch (Hamming aligned-box cuts) is
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network.backend import cut_scores
from repro_torch.network.geometry import Geometry, _divisors, canonical

__all__ = ["CutTable", "cut_table"]


def _aligned_assignments(a: Geometry, t: int) -> np.ndarray:
    """All aligned side assignments of volume t into torus dims ``a``.

    Row k is ``(s_1, ..., s_D)`` with ``s_i | t``, ``s_i <= a_i`` and
    ``prod s_i == t`` — every feasible embedding of every fitting cuboid
    geometry, built dimension by dimension as a pruned divisor meshgrid
    (each step crosses the surviving partial assignments with the divisor
    list, keeping rows whose remaining volume divides out and still fits
    in the remaining dimensions).  Empty (shape (0, D)) when nothing fits.
    """
    D = len(a)
    divs = _divisors(t, cap=max(a, default=0))
    suffix = [1] * (D + 1)  # suffix[i] = prod(a[i:])
    for i in range(D - 1, -1, -1):
        suffix[i] = suffix[i + 1] * a[i]
    rows = np.zeros((1, 0), dtype=np.int64)
    rem = np.array([t], dtype=np.int64)
    for i, ai in enumerate(a):
        cand = divs[divs <= ai]
        ok = (rem[:, None] % cand[None, :]) == 0
        nrem = rem[:, None] // cand[None, :]
        ok &= nrem <= suffix[i + 1]
        r, c = np.nonzero(ok)
        rows = np.concatenate([rows[r], cand[c][:, None]], axis=1)
        rem = nrem[r, c]
    return rows[rem == 1]


@dataclass(frozen=True)
class CutTable:
    """Every canonical cuboid geometry of volume ``t`` fitting ``dims``,
    with its exact minimum cut (links, double-link convention).

    ``geometries`` is a (G, D) int array of canonical (sorted-descending)
    rows in ascending lexicographic order; ``cuts`` the matching (G,)
    minimum cut per geometry (minimised over all feasible embeddings).
    """

    dims: Geometry
    t: int
    geometries: np.ndarray
    cuts: np.ndarray

    def __len__(self) -> int:
        return len(self.geometries)

    def geometry(self, i: int) -> Geometry:
        """The i-th canonical geometry as a plain tuple."""
        return tuple(int(x) for x in self.geometries[i])

    def items(self) -> List[Tuple[Geometry, int]]:
        """(geometry, cut) pairs in the table's lexicographic row order."""
        return [(self.geometry(i), int(self.cuts[i])) for i in range(len(self))]

    def min_cut_geometry(self) -> Tuple[Geometry, int]:
        """Lexicographically-smallest geometry attaining the minimum cut."""
        i = int(np.nonzero(self.cuts == self.cuts.min())[0][0])
        return self.geometry(i), int(self.cuts[i])

    def max_cut_geometry(self) -> Tuple[Geometry, int]:
        """Lexicographically-largest geometry attaining the maximum cut."""
        i = int(np.nonzero(self.cuts == self.cuts.max())[0][-1])
        return self.geometry(i), int(self.cuts[i])


def cut_table(torus_or_dims, t: int, device: DeviceLike = "cuda") -> CutTable:
    """Exact minimum cuts of every cuboid geometry of volume ``t`` in a
    torus (a dims tuple or any object with ``.dims``): a side ``s``
    embedded in torus dimension ``a`` contributes ``0`` if ``s == a`` else
    ``2 t / s``.  The cuts are scored on ``device``; the table equals the
    JAX package's ``cut_table`` in int64."""
    resolve_device(device)
    if t < 1:
        raise ValueError(f"t must be >= 1, got {t}")
    if hasattr(torus_or_dims, "link_multiplicity"):
        raise NotImplementedError(
            "cut_table on a HyperXFabric is not ported (ROADMAP Queue 1, the "
            "network engines: the HyperX branch of cut_table)"
        )
    a = canonical(getattr(torus_or_dims, "dims", torus_or_dims))
    S = _aligned_assignments(a, t)
    if S.shape[0] == 0:
        return CutTable(a, t, S.reshape(0, len(a)), np.zeros(0, dtype=np.int64))
    av = np.array(a, dtype=np.int64)
    cuts = cut_scores(a, S, t, device=device)
    G = -np.sort(-S, axis=1)  # canonical (descending) rows
    # Group by geometry via a positional integer key (base max(a)+1): a 1-D
    # unique on int64 keys, with the ascending-lexicographic row order of
    # np.unique(axis=0).
    base = int(av.max()) + 1
    key = G[:, 0].copy()
    for j in range(1, G.shape[1]):
        key = key * base + G[:, j]
    _, index, inv = np.unique(key, return_index=True, return_inverse=True)
    uniq = G[index]
    best = np.full(len(index), np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(best, inv.ravel(), cuts)
    return CutTable(a, t, uniq, best)
