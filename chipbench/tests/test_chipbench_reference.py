"""The plain reference against the program, on the CPU at reduced sizes and
in float32, where the two differ by rounding alone.  (The test imports both;
the reference imports nothing of the program.)"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from chipbench import checks, harness
from chipbench.entries import score, train
from chipbench.reference.plain import fp8_mm
from chipbench.tests.cells import small_cell

SEED = 2**35 + 11


def float32_cell(workload: str, **traffic):
    cell = small_cell(workload, **traffic)
    return dataclasses.replace(cell, cfg=dict(cell.cfg, param_dtype="float32", activation_dtype="float32"))


@pytest.mark.parametrize("workload", ["granite-3-8b.score-4k", "granite-3-8b.score-512"])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_last_logits_match_the_program(workload, impl):
    from repro_torch.models import model as model_lib
    from repro_torch.train import steps

    cell = float32_cell(workload, rows=3, length=40)
    weights = harness.family(cell.cfg).init_weights(cell.cfg, harness.subseed(SEED, "weights"), "cpu")
    pool = harness.token_pool(cell.cfg, cell.traffic, SEED, "cpu")
    prefill = steps.make_prefill_step(model_lib.build_model(harness.arch_config(cell.cfg), impl=impl))
    got = prefill(weights, {"tokens": pool[score.batch_index(cell, 0)]})[:, : cell.cfg["vocab_size"]]
    want = score.reference_logits(cell, SEED, [(0, r) for r in range(3)], torch.device("cpu"))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())
    numbers = checks.logit_numbers(got, want)
    assert numbers["logit_rms"] < 1e-4 and numbers["top1_gap"] == 0


def test_training_matches_the_program():
    cell = float32_cell("granite-3-8b-pp5.train-4k", rows=4, length=24)
    step, weights, state, pool = train.build(cell, SEED, torch.device("cpu"))
    _, _, prog = train.checked_steps(cell, step, weights, state, pool)
    ref = train.reference_steps(cell, SEED, torch.device("cpu"))
    assert set(prog["grad"]) == set(ref["grad"]) == set(ref["change"])
    assert prog["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    numbers = checks.train_numbers(prog, ref)
    assert numbers["grad_gap"] < 1e-4 and numbers["change_gap"] < 1e-3, numbers


@pytest.mark.parametrize("workload", ["granite-3-8b.score-4k", "granite-3-8b.score-512"])
def test_control_reads_worse_than_the_program(workload):
    """The float8 control against the reference reads several times the
    bfloat16 program's gap (at reduced sizes; the cell's own readings are
    the card's, in PERF.md)."""
    from repro_torch.models import model as model_lib
    from repro_torch.train import steps

    cell = small_cell(workload, rows=2, length=64)
    pairs = [(0, 0), (0, 1)]
    weights, pool, prefill = score.build(cell, SEED, torch.device("cpu"))
    got = prefill(weights, {"tokens": pool[score.batch_index(cell, 0)]})[:, : cell.cfg["vocab_size"]].float()
    ref = score.reference_logits(cell, SEED, pairs, torch.device("cpu"))
    control = score.reference_logits(cell, SEED, pairs, torch.device("cpu"), fp8_mm)
    assert checks.logit_numbers(control, ref)["logit_rms"] > 2 * checks.logit_numbers(got, ref)["logit_rms"]
