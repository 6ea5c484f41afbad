"""Fault-tolerance runtime of the port (counterpart of ``repro.runtime``)."""

from .fault_tolerance import (
    ElasticPlan,
    HeartbeatMonitor,
    StragglerTracker,
    SupervisorReport,
    TrainingSupervisor,
    failure_cells,
    plan_mesh,
)

__all__ = [
    "ElasticPlan",
    "HeartbeatMonitor",
    "StragglerTracker",
    "SupervisorReport",
    "TrainingSupervisor",
    "failure_cells",
    "plan_mesh",
]
