"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
reduced sizes, each fault the cell can have planted in the program.  (One
card a cell, so no fault of the exchange between cards.)"""

from __future__ import annotations

import time

import pytest
import torch

from chipbench import harness
from chipbench.tests.cells import small_cell

SEED = 2**34 + 5


def run(workload: str, **traffic) -> dict:
    return harness.run_cell(small_cell(workload, **traffic), SEED, 0.2, False, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("workload", ["granite-3-8b.score-4k", "granite-3-8b.score-512"])
@pytest.mark.parametrize("fault", ["none", "answer_of_another_row", "last_token_altered"])
def test_score_faults(workload, fault, monkeypatch):
    from repro_torch.train import steps

    make = steps.make_prefill_step

    def broken(model):
        prefill = make(model)

        def step(params, batch):
            tokens = batch["tokens"]
            if fault == "last_token_altered":
                tokens = tokens.clone()
                tokens[:, -1] = (tokens[:, -1] + 1) % model.cfg.vocab_size
            out = prefill(params, {"tokens": tokens})
            return out.roll(1, dims=0) if fault == "answer_of_another_row" else out

        return step

    monkeypatch.setattr(steps, "make_prefill_step", broken)
    line = run(workload)
    assert line["correct"] is (fault == "none"), line["checks"]


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "half_batch", "update_doubled"])
def test_train_faults(fault, monkeypatch):
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    make, update = steps.make_train_step, adamw.update

    def unchanged(cfg, grads, state, params):
        _, new_state, metrics = update(cfg, grads, state, _copy(params))  # the step's state moves, not the weights
        return params, new_state, metrics

    def broken(model, opt, microbatches=1, **kw):
        step = make(model, opt, microbatches=microbatches, **kw)

        def faulty(params, state, batch):
            if fault == "half_batch":
                batch = {"tokens": batch["tokens"][: batch["tokens"].shape[0] // 2]}
            before = _copy(params)
            params, state, metrics = step(params, state, batch)
            if fault == "update_doubled":  # the step's answer altered where it is made
                _double(params, before)
            return params, state, metrics

        return faulty

    if fault == "state_unchanged":
        monkeypatch.setattr(adamw, "update", unchanged)
    monkeypatch.setattr(steps, "make_train_step", broken)
    line = run("granite-3-8b-pp5.train-4k", rows=4, length=32)
    assert line["correct"] is (fault == "none"), line["checks"]


def _double(tree, before):
    if isinstance(tree, dict):
        for k in tree:
            _double(tree[k], before[k])
    else:
        tree.add_(tree - before)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone()
