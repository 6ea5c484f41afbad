"""The network engines' compiled passes, ported from the ``xla`` backend of
``repro.network`` (``network/backend.py``), with the NumPy helpers they
need copied beside them.

Entry points take NumPy in and give NumPy out, as the JAX functions do,
with the JAX function's signature plus ``device="cuda"``: they run on the
card unless the caller passes ``device="cpu"``, and raise without a card.
Integer or dyadic volumes make link loads and candidate scores exact on
either device; see :mod:`repro_torch.network.backend`.
"""

from repro_torch.network.backend import (
    DrainPlan,
    cut_scores,
    drain,
    drain_batch,
    prepare_drain,
    route_loads,
    score_candidates,
)
from repro_torch.network.geometry import canonical, volume
from repro_torch.network.isoperimetry import CutTable, cut_table
from repro_torch.network.mapping import MappingScore, pattern_traffic, score_mapping
from repro_torch.network.netsim import (
    FlowPaths,
    FlowSimResult,
    dor_paths,
    link_capacities,
    simulate_flows,
    simulate_traffic,
)
from repro_torch.network.patterns import (
    all_to_all,
    bisection_pairing,
    furthest_offset,
    nearest_neighbor_halo,
    pairing_pairs,
    uniform_shift,
    vertices,
)
from repro_torch.network.placement import (
    base_loads,
    contention_field,
    interference_mask,
    orientations,
    placement_all_to_all_traffic,
)
from repro_torch.network.routing import max_link_load, route_dor

__all__ = [
    "CutTable",
    "DrainPlan",
    "FlowPaths",
    "FlowSimResult",
    "MappingScore",
    "all_to_all",
    "base_loads",
    "bisection_pairing",
    "canonical",
    "contention_field",
    "cut_scores",
    "cut_table",
    "dor_paths",
    "drain",
    "drain_batch",
    "furthest_offset",
    "interference_mask",
    "link_capacities",
    "max_link_load",
    "nearest_neighbor_halo",
    "orientations",
    "pairing_pairs",
    "pattern_traffic",
    "placement_all_to_all_traffic",
    "prepare_drain",
    "route_dor",
    "route_loads",
    "score_candidates",
    "score_mapping",
    "simulate_flows",
    "simulate_traffic",
    "uniform_shift",
    "vertices",
    "volume",
]
