"""The control on the card at each cell's own sizes: the program's reading
passes the cell's limits and the float8 control's (and, training, the
half-batch fault's) fails one of them.  Needs a CUDA card; run with
``python -m pytest -q -m cuda chipbench/tests`` (a few minutes a cell)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from chipbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload, card):
    cell = harness.resolve(workload)
    readings = {"score": control.score_readings, "train": control.train_readings}[cell.traffic["entry"]]
    sides = dict(readings(cell, 2**33 + 17, card, 1, True))
    passes = lambda numbers: all(numbers[k] <= lim["limit"] for k, lim in cell.limits.items())
    assert passes(sides["program"]), sides["program"]
    for side in ("control_fp8", "fault_half_batch"):
        if side in sides:
            assert not passes(sides[side]), (side, sides[side])
