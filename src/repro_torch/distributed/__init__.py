"""The distributed layer (port of ``repro.distributed``): so far only the
partition-spec validator the fleet planner checks its rules with."""
