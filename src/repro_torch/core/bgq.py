"""IBM Blue Gene/Q machine models (paper Section 2 & 3.2): the port's copy
of ``repro.core.bgq``.

A Blue Gene/Q system is a 5D torus of compute nodes whose 5th dimension has
length 2 and is internal to each *midplane* (a 4x4x4x4x2 block of 512 nodes).
Partitions are cuboids of whole midplanes and — crucially for the paper's
analysis — retain wrap-around links in every dimension even when they do not
span the full machine, so a partition of midplane geometry (m1, m2, m3, m4)
is itself a torus with node dimensions (4*m1, 4*m2, 4*m3, 4*m4, 2).

Bisection bandwidth of a Blue Gene/Q (sub-)torus is 2 * N / L * B where N is
the node count, L the longest node dimension and B the per-link capacity
(Chen et al. 2012).  All tables report normalized capacity B = 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.network.fabric import Torus
from repro_torch.network.geometry import Geometry, canonical, volume

MIDPLANE_DIMS: Geometry = (4, 4, 4, 4, 2)
MIDPLANE_NODES: int = volume(MIDPLANE_DIMS)  # 512
LINK_BANDWIDTH_GB_S: float = 2.0  # GB/s per direction per link (Chen et al. 2012)


def node_dims_of_midplane_geometry(midplanes: Sequence[int]) -> Geometry:
    """Node-level torus dims of a midplane cuboid (4x per dim, plus the
    internal 5th dimension of length 2)."""
    m = canonical(midplanes)
    if len(m) != 4:
        raise ValueError(f"midplane geometry must be 4-dimensional, got {m}")
    return canonical(tuple(4 * d for d in m) + (2,))


def partition_bisection_links(midplanes: Sequence[int]) -> int:
    """Internal bisection (links, capacity 1) of a midplane-cuboid partition."""
    return Torus(node_dims_of_midplane_geometry(midplanes)).bisection_links()


@dataclass(frozen=True)
class BlueGeneQ:
    """A Blue Gene/Q machine: a 4D torus of midplanes."""

    name: str
    midplane_dims: Geometry

    def __init__(self, name: str, midplane_dims: Sequence[int]):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "midplane_dims", canonical(midplane_dims))
        if len(self.midplane_dims) != 4:
            raise ValueError("Blue Gene/Q midplane torus is 4-dimensional")

    @property
    def num_midplanes(self) -> int:
        return volume(self.midplane_dims)

    @property
    def num_nodes(self) -> int:
        return self.num_midplanes * MIDPLANE_NODES

    @property
    def node_dims(self) -> Geometry:
        return node_dims_of_midplane_geometry(self.midplane_dims)

    @property
    def midplane_torus(self) -> Torus:
        return Torus(self.midplane_dims)

    @property
    def node_torus(self) -> Torus:
        return Torus(self.node_dims)

    def machine_bisection_links(self) -> int:
        return self.node_torus.bisection_links()

    # -- partitions ------------------------------------------------------------
    def partition_geometries(self, num_midplanes: int) -> List[Geometry]:
        """All canonical midplane-cuboid geometries of a given midplane count
        that fit inside the machine."""
        return sorted(self.midplane_torus.sub_cuboids(num_midplanes), reverse=True)

    def partition_sizes(self) -> List[int]:
        """All midplane counts for which at least one cuboid partition exists."""
        return [
            m
            for m in range(1, self.num_midplanes + 1)
            if any(True for _ in self.midplane_torus.sub_cuboids(m))
        ]

    def best_partition(self, num_midplanes: int) -> Optional[Tuple[Geometry, int]]:
        """Geometry with maximal internal bisection bandwidth (links)."""
        best: Optional[Tuple[Geometry, int]] = None
        for g in self.partition_geometries(num_midplanes):
            bw = partition_bisection_links(g)
            if best is None or bw > best[1] or (bw == best[1] and g < best[0]):
                best = (g, bw)
        return best

    def worst_partition(self, num_midplanes: int) -> Optional[Tuple[Geometry, int]]:
        """Geometry with minimal internal bisection bandwidth (links)."""
        worst: Optional[Tuple[Geometry, int]] = None
        for g in self.partition_geometries(num_midplanes):
            bw = partition_bisection_links(g)
            if worst is None or bw < worst[1] or (bw == worst[1] and g > worst[0]):
                worst = (g, bw)
        return worst


# ---------------------------------------------------------------------------
# The machines studied in the paper.
# ---------------------------------------------------------------------------
MIRA = BlueGeneQ("Mira", (4, 4, 3, 2))           # 49152 nodes, 16x16x12x8x2
JUQUEEN = BlueGeneQ("JUQUEEN", (7, 2, 2, 2))     # 28672 nodes, 28x8x8x8x2
SEQUOIA = BlueGeneQ("Sequoia", (4, 4, 4, 3))     # 98304 nodes, 16x16x16x12x2
# Hypothetical machines from Section 5 ("Machine design"):
JUQUEEN54 = BlueGeneQ("JUQUEEN-54", (3, 3, 3, 2))
JUQUEEN48 = BlueGeneQ("JUQUEEN-48", (4, 3, 2, 2))

MACHINES: Dict[str, BlueGeneQ] = {
    m.name: m for m in (MIRA, JUQUEEN, SEQUOIA, JUQUEEN54, JUQUEEN48)
}

# Mira's scheduler exposes a fixed list of partition geometries (paper
# Table 6, "Current Geometry"), keyed by midplane count.
MIRA_SCHEDULER_PARTITIONS: Dict[int, Geometry] = {
    1: (1, 1, 1, 1),
    2: (2, 1, 1, 1),
    4: (4, 1, 1, 1),
    8: (4, 2, 1, 1),
    16: (4, 4, 1, 1),
    24: (4, 3, 2, 1),
    32: (4, 4, 2, 1),
    48: (4, 4, 3, 1),
    64: (4, 4, 2, 2),
    96: (4, 4, 3, 2),
}

# The geometries proposed in the paper where an improvement exists (Table 1).
MIRA_PROPOSED_PARTITIONS: Dict[int, Geometry] = {
    4: (2, 2, 1, 1),
    8: (2, 2, 2, 1),
    16: (2, 2, 2, 2),
    24: (3, 2, 2, 2),
}


def mira_partition_table() -> List[dict]:
    """Reproduces paper Table 6 (and its improved-rows subset, Table 1)."""
    rows = []
    for mp, current in sorted(MIRA_SCHEDULER_PARTITIONS.items()):
        current_bw = partition_bisection_links(current)
        best = MIRA.best_partition(mp)
        assert best is not None
        proposed: Optional[Geometry] = None
        proposed_bw: Optional[int] = None
        if best[1] > current_bw:
            proposed, proposed_bw = best
        rows.append(
            {
                "nodes": mp * MIDPLANE_NODES,
                "midplanes": mp,
                "current_geometry": current,
                "current_bw": current_bw,
                "proposed_geometry": proposed,
                "proposed_bw": proposed_bw,
            }
        )
    return rows


def juqueen_partition_table(machine: BlueGeneQ = JUQUEEN) -> List[dict]:
    """Reproduces paper Table 7: best and worst geometry per midplane count."""
    rows = []
    for mp in machine.partition_sizes():
        worst = machine.worst_partition(mp)
        best = machine.best_partition(mp)
        assert worst is not None and best is not None
        rows.append(
            {
                "nodes": mp * MIDPLANE_NODES,
                "midplanes": mp,
                "worst_geometry": worst[0],
                "worst_bw": worst[1],
                "best_geometry": best[0] if best[1] > worst[1] else None,
                "best_bw": best[1] if best[1] > worst[1] else None,
            }
        )
    return rows


def machine_design_table() -> List[dict]:
    """Reproduces paper Table 5: best-case partitions of JUQUEEN vs the
    hypothetical JUQUEEN-54 and JUQUEEN-48."""
    rows: Dict[int, dict] = {}
    for machine, key in ((JUQUEEN, "juqueen"), (JUQUEEN54, "j54"), (JUQUEEN48, "j48")):
        for mp in machine.partition_sizes():
            best = machine.best_partition(mp)
            assert best is not None
            row = rows.setdefault(
                mp, {"nodes": mp * MIDPLANE_NODES, "midplanes": mp}
            )
            row[f"{key}_geometry"] = best[0]
            row[f"{key}_bw"] = best[1]
    return [rows[mp] for mp in sorted(rows)]
