"""Partition-spec validation (port of the pure-Python part of
``repro.distributed.sharding``).

A PartitionSpec-style rule is a sequence of per-dimension entries: ``None``,
a mesh-axis name, or a tuple of names.  The fleet planner validates every
rule it enumerates.  ``ShardingRules`` and the rest of the JAX module
belong to the dry-run and are not ported.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Sequence, Union

__all__ = ["validate_partition_spec"]


def _flatten_spec_axes(spec) -> List[str]:
    """Mesh-axis names referenced by one PartitionSpec-style entry tuple."""
    flat = []
    for entry in spec:
        if entry is None:
            continue
        flat.extend(entry if isinstance(entry, tuple) else (entry,))
    return flat


def validate_partition_spec(spec: Sequence, mesh_axes: Union[Mapping[str, int], Iterable[str]]) -> None:
    """Reject ill-formed PartitionSpec-style rules.

    ``mesh_axes`` is the mesh's axis-name collection (a dict of sizes or an
    iterable of names).  Raises ``ValueError`` when a mesh axis is reused
    across dimensions (or twice within one dimension group), since a cost
    model fed such a rule double-counts the axis, and when a rule
    references an axis that does not exist on the mesh.

    >>> validate_partition_spec((("data", "fsdp"), "tensor"), ["data", "fsdp", "tensor"])
    >>> validate_partition_spec(("data", "data"), {"data": 2})
    Traceback (most recent call last):
    ...
    ValueError: partition spec ('data', 'data') reuses mesh axes ['data'] across conflicting tensor dimensions
    """
    names = tuple(mesh_axes)
    known = set(names)
    flat = _flatten_spec_axes(spec)
    unknown = [a for a in flat if a not in known]
    if unknown:
        raise ValueError(
            f"partition spec {tuple(spec)} references axes {unknown} absent "
            f"from mesh axes {names}"
        )
    if len(flat) != len(set(flat)):
        dupes = sorted({a for a in flat if flat.count(a) > 1})
        raise ValueError(
            f"partition spec {tuple(spec)} reuses mesh axes {dupes} across "
            f"conflicting tensor dimensions"
        )
