"""Edge-isoperimetry on Hamming graphs — the HyperX analogue of Section 3.

A HyperX fabric (Ahn et al.; Cano et al., *Resource Allocation in HyperX
Networks*) is the Hamming graph ``H(S_1, ..., S_D)``: the product of
complete graphs, one clique per dimension, optionally with a per-dimension
link multiplicity ``K_k`` (parallel links / trunking).  Every cut and
bound the torus engine computes for :mod:`repro_torch.network.geometry` has a
Hamming counterpart here:

* the **exact cut of any vertex set** decomposes per dimension line
  (each line is a clique): a line holding ``m`` of the set's vertices
  contributes ``K_k * m * (S_k - m)`` crossing edges
  (:func:`hamming_cut_of_set`);
* an **aligned box** with sides ``c_k`` has the closed-form cut
  ``t * sum_k K_k (S_k - c_k)`` (:func:`hamming_cut_aligned`) — note the
  opposite monotonicity to tori: *longer* sides mean *smaller* cuts,
  because covering a clique dimension removes its whole contribution;
* the **lower bound** on any size-``t`` set's cut comes through the edge
  identity ``cut(S) = t * degree - 2 * E(S)``: maximising induced edges
  minimises the cut.  For uniform multiplicity, **Lindsey's lemma** says
  the lexicographic initial segment with coordinates ordered by
  *decreasing* dimension size (largest dimension varying fastest)
  maximises ``E(S)`` — :func:`lex_max_edges` evaluates it by a
  divide-out recursion, making :func:`lindsey_bound` the exact
  isoperimetric minimum.  With non-uniform multiplicities lex order is
  *not* optimal (small counterexamples exist), so the bound falls back
  to the sound per-dimension packing relaxation
  (:func:`packed_edges_bound`) and is a floor rather than the optimum.

The port's copy of ``repro.network.hamming``: the closed forms, the lex
order and the bounds are host integer arithmetic;
:func:`hamming_cut_of_set` counts line occupancies on ``device`` (one
``bincount`` per dimension, int64), and :func:`hamming_bisection_links`
evaluates the same count on the host for the Lindsey half-set.

>>> lindsey_bound((16, 4), 16)   # one full 16-line: cut = 16 * (18 - 2*15)/...
48
>>> hamming_cut_aligned((16, 4), (16, 1))
48
>>> hamming_bisection_links((16, 1))
64
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.network.geometry import volume
from repro_torch.obs import count_dispatch

__all__ = [
    "hamming_bisection_links",
    "hamming_cut_aligned",
    "hamming_cut_of_set",
    "hamming_degree",
    "hamming_num_edges",
    "hamming_subset_bound",
    "lex_cells",
    "lex_max_edges",
    "lindsey_bound",
    "packed_edges_bound",
]


def _mult(dims: Sequence[int], mult: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """Normalise a per-dimension link multiplicity (default: all ones)."""
    d = tuple(int(a) for a in dims)
    if mult is None:
        return (1,) * len(d)
    m = tuple(int(k) for k in mult)
    if len(m) != len(d):
        raise ValueError(f"multiplicity {m} must have one entry per dim of {d}")
    if any(k < 1 for k in m):
        raise ValueError(f"multiplicities must be >= 1, got {m}")
    return m


def hamming_degree(dims: Sequence[int], mult: Optional[Sequence[int]] = None) -> int:
    """Vertex degree of ``H(dims)``: every other vertex of each dimension
    line is one hop away, ``sum_k K_k * (S_k - 1)``.

    >>> hamming_degree((16, 4))
    18
    """
    m = _mult(dims, mult)
    return sum(k * (a - 1) for a, k in zip(dims, m))


def hamming_num_edges(dims: Sequence[int], mult: Optional[Sequence[int]] = None) -> int:
    """Total edge count: ``N / S_k`` lines per dimension, each a clique.

    >>> hamming_num_edges((4, 4))
    48
    """
    d = tuple(int(a) for a in dims)
    m = _mult(d, mult)
    n = volume(d)
    return sum(k * (n // a) * (a * (a - 1) // 2) for a, k in zip(d, m))


def hamming_cut_aligned(
    dims: Sequence[int], sides: Sequence[int], mult: Optional[Sequence[int]] = None
) -> int:
    """Exact cut of an aligned box with ``sides[k]`` coordinates in dim k.

    Each of the box's ``t`` vertices sees ``S_k - c_k`` vertices outside
    its dim-k line segment, so the cut is ``t * sum_k K_k (S_k - c_k)`` —
    monotone *decreasing* in every side (cover a dimension, kill its term).

    >>> hamming_cut_aligned((4, 4), (4, 1)), hamming_cut_aligned((4, 4), (2, 2))
    (12, 16)
    """
    d = tuple(int(a) for a in dims)
    c = tuple(int(x) for x in sides)
    if len(c) != len(d):
        raise ValueError(f"sides {c} must have one entry per dim of {d}")
    if any(x < 1 or x > a for x, a in zip(c, d)):
        raise ValueError(f"sides {c} must satisfy 1 <= side <= dim for dims {d}")
    m = _mult(d, mult)
    t = volume(c)
    return t * sum(k * (a - x) for a, x, k in zip(d, c, m))


def _line_ids(d: Tuple[int, ...], k: int, cells):
    """Each cell's dimension-k line: the C-order index of its other
    coordinates (NumPy or torch (t, D) int64 cells)."""
    line = cells[:, 0] * 0
    for j, a in enumerate(d):
        if j != k:
            line = line * a + cells[:, j]
    return line


def _cells_array(d: Tuple[int, ...], cells) -> np.ndarray:
    cells = np.atleast_2d(np.asarray(cells, dtype=np.int64))
    if cells.shape[0] and cells.shape[1] != len(d):
        raise ValueError(f"cells must have shape (t, {len(d)}); got {cells.shape}")
    return cells


def hamming_cut_of_set(
    dims: Sequence[int],
    cells: np.ndarray,
    mult: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> int:
    """Exact cut of an arbitrary vertex set, by per-line occupancy on
    ``device``.

    ``cells`` is a (t, D) int array of coordinates.  Within each dimension
    the vertex set partitions into lines (cliques); a line holding ``m``
    members contributes ``K_k * m * (S_k - m)`` crossing edges.  One
    ``bincount`` per dimension in int64 — no pairwise enumeration.

    >>> import numpy as np
    >>> hamming_cut_of_set((4, 4), np.array([[0, 0], [0, 1], [1, 0], [1, 1]]), device="cpu")
    16
    """
    dev = resolve_device(device)
    d = tuple(int(a) for a in dims)
    m = _mult(d, mult)
    cells = _cells_array(d, cells)
    if cells.shape[0] == 0:
        return 0
    count_dispatch("hamming_cut_of_set", dev.type)
    c = torch.from_numpy(np.ascontiguousarray(cells)).to(dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for k, a in enumerate(d):
        occ = torch.bincount(_line_ids(d, k, c))
        total += m[k] * (occ * (a - occ)).sum()
    return int(total)


def _cut_of_set_host(d: Tuple[int, ...], cells: np.ndarray, m: Tuple[int, ...]) -> int:
    """:func:`hamming_cut_of_set` in NumPy (the closed forms' host path)."""
    total = 0
    for k, a in enumerate(d):
        occ = np.bincount(_line_ids(d, k, cells))
        total += int(m[k] * (occ * (a - occ)).sum())
    return total


# ---------------------------------------------------------------------------
# Lindsey's lemma: the lex initial segment maximises induced edges.
# ---------------------------------------------------------------------------
def _desc(dims: Sequence[int], mult: Optional[Sequence[int]]):
    """Dims (with matching multiplicities) sorted by decreasing size —
    the Lindsey order: the largest dimension varies fastest (innermost)."""
    d = tuple(int(a) for a in dims)
    m = _mult(d, mult)
    order = sorted(range(len(d)), key=lambda k: (-d[k], k))
    return tuple(d[k] for k in order), tuple(m[k] for k in order)


def lex_cells(dims: Sequence[int], t: int) -> np.ndarray:
    """Coordinates of the first ``t`` cells in Lindsey lex order, as a
    (t, D) array in the *original* dimension order.

    The segment fills the largest dimension first (it varies fastest), so
    e.g. the first 16 cells of ``H(16, 4)`` are one full 16-line — the
    elongated box that minimises the Hamming cut, the exact opposite of
    the torus' compact optimum.

    >>> lex_cells((2, 3), 4).tolist()   # dim of size 3 varies fastest
    [[0, 0], [0, 1], [0, 2], [1, 0]]
    """
    d = tuple(int(a) for a in dims)
    n = volume(d)
    if not 0 <= t <= n:
        raise ValueError(f"t must be in [0, {n}], got {t}")
    order = sorted(range(len(d)), key=lambda k: (-d[k], k))
    sorted_dims = tuple(d[k] for k in order)
    # Unravel 0..t-1 with the largest dim as the last (fastest) axis, i.e.
    # C-order over dims sorted ascending-outer / descending-inner.
    idx = np.arange(t, dtype=np.int64)
    coords_sorted = np.stack(
        np.unravel_index(idx, sorted_dims[::-1]), axis=1
    )[:, ::-1]  # now column j corresponds to sorted_dims[j]
    out = np.empty((t, len(d)), dtype=np.int64)
    for j, k in enumerate(order):
        out[:, k] = coords_sorted[:, j]
    return out


def lex_max_edges(
    dims: Sequence[int], t: int, mult: Optional[Sequence[int]] = None
) -> int:
    """Induced edges of the Lindsey lex initial segment of size ``t``.

    Divide-out recursion on the outermost (smallest) dimension: with
    ``m`` cells per inner block and ``t = q*m + r``, the segment is ``q``
    full inner copies plus the lex-first ``r`` cells of the next copy;
    outer-dimension lines then hold ``q+1`` members at ``r`` inner
    positions and ``q`` at the rest.  For uniform multiplicity this *is*
    the maximum over all size-``t`` sets (Lindsey's lemma; brute-force
    verified in the test suite) — with non-uniform multiplicities it is
    only the lex segment's own edge count.

    >>> lex_max_edges((16, 4), 16)   # one full 16-clique
    120
    """
    d, m = _desc(dims, mult)
    n = volume(d)
    if not 0 <= t <= n:
        raise ValueError(f"t must be in [0, {n}], got {t}")

    def rec(ds: Tuple[int, ...], ms: Tuple[int, ...], size: int) -> int:
        if size <= 1:
            return 0
        if len(ds) == 1:
            return ms[0] * size * (size - 1) // 2
        inner_ds, inner_ms = ds[:-1], ms[:-1]
        k_outer = ms[-1]
        block = math.prod(inner_ds)
        q, r = divmod(size, block)
        return (
            q * hamming_num_edges(inner_ds, inner_ms)
            + rec(inner_ds, inner_ms, r)
            + k_outer * (r * (q * (q + 1) // 2) + (block - r) * (q * (q - 1) // 2))
        )

    return rec(d, m, t)


def packed_edges_bound(
    dims: Sequence[int], t: int, mult: Optional[Sequence[int]] = None
) -> int:
    """Sound upper bound on induced edges for *any* multiplicities.

    Per dimension independently, ``t`` vertices induce the most dim-k
    edges by packing whole lines: ``q`` full ``S_k``-cliques plus one
    ``r``-clique (``q, r = divmod(t, S_k)``).  Summing the per-dimension
    maxima relaxes the joint constraint, so this dominates the true
    maximum (and the Lindsey value); it is what keeps
    :func:`lindsey_bound` sound when multiplicities differ per dimension,
    where lex segments are provably not optimal.
    """
    d = tuple(int(a) for a in dims)
    m = _mult(d, mult)
    total = 0
    for a, k in zip(d, m):
        q, r = divmod(t, a)
        total += k * (q * (a * (a - 1) // 2) + r * (r - 1) // 2)
    return total


def lindsey_bound(
    dims: Sequence[int], t: int, mult: Optional[Sequence[int]] = None
) -> int:
    """Lower bound on the cut of *any* ``t``-subset of ``H(dims)``.

    Via the edge identity ``cut(S) = t * degree - 2 * E(S)``: an upper
    bound on induced edges is a lower bound on the cut.  Uniform
    multiplicity uses the exact Lindsey maximum (:func:`lex_max_edges`),
    making this the exact isoperimetric minimum; otherwise the packing
    relaxation (:func:`packed_edges_bound`) keeps it sound.

    >>> lindsey_bound((4, 4), 8)     # two full lines: 8 * 6 - 2 * 16
    16
    """
    d = tuple(int(a) for a in dims)
    m = _mult(d, mult)
    if not 0 <= t <= volume(d):
        raise ValueError(f"t must be in [0, {volume(d)}], got {t}")
    if len(set(m)) <= 1:
        e_max = lex_max_edges(d, t, m)
    else:
        e_max = packed_edges_bound(d, t, m)
    return max(0, t * hamming_degree(d, m) - 2 * e_max)


def hamming_subset_bound(
    dims: Sequence[int], t: int, mult: Optional[Sequence[int]] = None
) -> int:
    """:func:`lindsey_bound` with complement symmetry: every edge leaving
    ``S`` enters its complement, so the bound at ``min(t, n - t)``
    applies to sets of either size."""
    n = volume(tuple(int(a) for a in dims))
    return lindsey_bound(dims, min(t, n - t), mult)


def hamming_bisection_links(
    dims: Sequence[int], mult: Optional[Sequence[int]] = None
) -> int:
    """Internal bisection (links) of ``H(dims)``: the minimum cut over all
    ``floor(n/2)``-subsets, evaluated as the *explicit* cut of the Lindsey
    lex segment via per-line occupancy (:func:`hamming_cut_of_set`) — an
    achievable construction, certified optimal against the independent
    closed-form recursion by :func:`lindsey_bound` (exact for uniform
    multiplicity; for non-uniform fabrics the construction is still
    achievable but only floor-certified).

    >>> hamming_bisection_links((16, 1)), hamming_bisection_links((4, 4))
    (64, 16)
    """
    d = tuple(int(a) for a in dims)
    n = volume(d)
    if n <= 1:
        return 0
    return _cut_of_set_host(d, lex_cells(d, n // 2), _mult(d, mult))
