"""Fault-tolerance runtime of the port (counterpart of ``repro.runtime``)."""

from .fault_tolerance import (
    ElasticPlan,
    HeartbeatMonitor,
    StragglerTracker,
    SupervisorReport,
    TrainingSupervisor,
    plan_mesh,
)

__all__ = [
    "ElasticPlan",
    "HeartbeatMonitor",
    "StragglerTracker",
    "SupervisorReport",
    "TrainingSupervisor",
    "plan_mesh",
]
