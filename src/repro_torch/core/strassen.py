"""Strassen-Winograd fast matrix multiplication (the paper's Experiment B;
port of ``repro.core.strassen``).

The paper benchmarks the communication-avoiding parallel Strassen (CAPS) of
Ballard/Lipshitz et al. on Mira partitions.  Here:

* ``strassen_winograd`` — the sequential Strassen-Winograd recursion in
  torch (7 multiplies, 15 additions per level, in the JAX package's order),
  with ``torch.matmul`` at the leaves; this is the per-node compute kernel.
* ``caps_comm_model`` — the partition-aware communication model for the
  BFS/DFS parallel execution: a fraction ``phi`` of the traffic is
  bisection-bound (crosses the partition bisection), the rest is
  injection-bound.  The predicted current/proposed comm-time ratio on a
  partition pair with bisection ratio r is  (1 - phi) + phi * r; the
  paper's measured x1.37–x1.52 for r = 2 corresponds to phi in [0.37, 0.52].
* ``MIRA_CAPS_CELLS`` — the paper's four Mira cells (midplanes, current
  and proposed geometry), priced by :func:`mira_caps_cells`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.core.bgq import partition_bisection_links


def strassen_winograd(a: torch.Tensor, b: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """Strassen-Winograd recursion to the given depth (then ``a @ b``)."""
    if depth == 0:
        return a @ b
    n, m = a.shape
    p = b.shape[1]
    if n % 2 or m % 2 or p % 2:
        raise ValueError(f"even dims required per level, got ({n}, {m}) x ({m}, {p})")
    a11, a12 = a[: n // 2, : m // 2], a[: n // 2, m // 2 :]
    a21, a22 = a[n // 2 :, : m // 2], a[n // 2 :, m // 2 :]
    b11, b12 = b[: m // 2, : p // 2], b[: m // 2, p // 2 :]
    b21, b22 = b[m // 2 :, : p // 2], b[m // 2 :, p // 2 :]

    s1 = a21 + a22
    s2 = s1 - a11
    s3 = a11 - a21
    s4 = a12 - s2
    t1 = b12 - b11
    t2 = b22 - t1
    t3 = b22 - b12
    t4 = t2 - b21

    rec = lambda x, y: strassen_winograd(x, y, depth - 1)
    m1 = rec(a11, b11)
    m2 = rec(a12, b21)
    m3 = rec(s4, b22)
    m4 = rec(a22, t4)
    m5 = rec(s1, t1)
    m6 = rec(s2, t2)
    m7 = rec(s3, t3)

    u1 = m1 + m2  # C11
    u2 = m1 + m6
    u3 = u2 + m7
    u4 = u2 + m5
    c12 = u4 + m3
    c21 = u3 - m4
    c22 = u3 + m5
    return torch.cat([torch.cat([u1, c12], dim=1), torch.cat([c21, c22], dim=1)], dim=0)


def strassen_flops(n: int, depth: int) -> float:
    """FLOPs of depth-k Strassen on n x n (7^k multiplies of (n/2^k)^3)."""
    base = n // (2 ** depth)
    return 7 ** depth * 2.0 * base ** 3 + 15 * sum(
        7 ** i * 2 * (n // 2 ** (i + 1)) ** 2 for i in range(depth)
    )


# ---------------------------------------------------------------------------
# CAPS communication model on partitions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CapsPrediction:
    midplanes: int
    bisection_ratio: float  # proposed / current
    comm_ratio: float  # T_comm(current) / T_comm(proposed)
    wallclock_ratio: float


def caps_comm_model(
    cells: List[Tuple[int, int, int]],  # (midplanes, current_bis, proposed_bis)
    phi: float = 0.45,
    comm_over_comp: float = 0.5,
) -> List[CapsPrediction]:
    """Predicted comm / wallclock ratios between partition geometries.

    ``phi``: bisection-bound traffic fraction of CAPS on these partitions
    (0.45 sits mid-band of the paper's measurements).  ``comm_over_comp``:
    unhidden communication time over computation time on the *proposed*
    partition (sets the wallclock dilution).
    """
    out = []
    for mp, cur, prop in cells:
        r = prop / cur
        comm_ratio = (1 - phi) + phi * r
        # wallclock = comp + comm; comm on proposed = comm_over_comp * comp
        comp = 1.0
        comm_prop = comm_over_comp
        comm_cur = comm_prop * comm_ratio
        wall = (comp + comm_cur) / (comp + comm_prop)
        out.append(CapsPrediction(mp, r, comm_ratio, wall))
    return out


#: The paper's four Mira cells of Figure 5: (midplanes, current geometry,
#: proposed geometry) in midplanes.
MIRA_CAPS_CELLS = (
    (4, (4, 1, 1, 1), (2, 2, 1, 1)),
    (8, (4, 2, 1, 1), (2, 2, 2, 1)),
    (16, (4, 4, 1, 1), (2, 2, 2, 2)),
    (24, (4, 3, 2, 1), (3, 2, 2, 2)),
)


def mira_caps_cells() -> List[Tuple[int, int, int]]:
    """:data:`MIRA_CAPS_CELLS` as (midplanes, current bisection links,
    proposed bisection links), the input of :func:`caps_comm_model`."""
    return [(mp, partition_bisection_links(cur), partition_bisection_links(prop))
            for mp, cur, prop in MIRA_CAPS_CELLS]
