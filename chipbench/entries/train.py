"""The ``train`` entry: the program's training step (``make_train_step``
with AdamW, a model built with ``impl="torch"``), one step after another.

Set-up builds the step, its weights and optimizer state once, drives it
through its first ``checked_steps`` steps on batches of distinct rows, and
reads what the comparison needs: each step's loss, each leaf's first
clipped gradient (AdamW's first moment after one step over 1 - beta1) and
each leaf's change over those steps.  The same step, weights and state
then run the window: whole steps until ``--seconds`` have passed, each on
the next batch of the pool.  The reference follows the checked steps.

Traffic keys: ``rows``, ``length``, ``microbatches``, ``remat``,
``optimizer`` (AdamW's settings), ``checked_steps``, ``pool_batches``.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch
from torch.profiler import record_function

from chipbench import checks, harness
from chipbench.reference import adamw as ref_adamw
from chipbench.reference.plain import exact_mm, set_exact_float32
from chipbench.trace import traced


def named(tree) -> Dict[str, torch.Tensor]:
    from repro_torch import tree as tree_lib

    return {"/".join(map(str, p)): t for p, t in tree_lib.leaves_with_path(tree)}


def build(cell, seed: int, device):
    """(step, weights, optimizer state, token pool) as the window uses them."""
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    tr = cell.traffic
    weights = harness.family(cell.cfg).init_weights(cell.cfg, harness.subseed(seed, "weights"), device)
    model = model_lib.build_model(harness.arch_config(cell.cfg), impl="torch", remat=tr["remat"])
    step = steps.make_train_step(model, adamw.AdamWConfig(**tr["optimizer"]), microbatches=tr["microbatches"])
    pool = harness.token_pool(cell.cfg, cell.traffic, seed, device)
    return step, weights, adamw.init(weights), pool


def checked_steps(cell, step, weights, state, pool):
    """Drive the first steps and read them.  Returns (weights, state,
    readings)."""
    b1 = cell.traffic["optimizer"]["beta1"]
    before = {k: t.clone() for k, t in named(weights).items()}
    losses = []
    for k in range(cell.traffic["checked_steps"]):
        weights, state, metrics = step(weights, state, {"tokens": pool[k]})
        losses.append(float(metrics["loss"]))
        if k == 0:
            grad = checks.leaf_norms((n, m / (1 - b1)) for n, m in named(state.m).items())
    change = checks.leaf_norms((n, t.float() - before[n].float()) for n, t in named(weights).items())
    return weights, state, {"losses": losses, "grad": grad, "change": change}


def reference_steps(cell, seed: int, device, mm=exact_mm) -> dict:
    """The reference's readings of the checked steps, from weights and
    batches made again from the seed."""
    set_exact_float32()
    fam = harness.family(cell.cfg)
    start = fam.init_weights(cell.cfg, harness.subseed(seed, "weights"), device)
    pool = harness.token_pool(cell.cfg, cell.traffic, seed, device)
    master = fam.master(start)
    leaves = dict(ref_adamw.named_leaves(master))
    initial = dict(ref_adamw.named_leaves(fam.split_layers(start)))
    trainer = ref_adamw.Trainer(leaves, lambda n: not n.endswith("scale"), cell.traffic["optimizer"])
    loss_sum = lambda rows, mm_: fam.loss_sum(master, cell.cfg, rows, mm_)
    losses = []
    for k in range(cell.traffic["checked_steps"]):
        out = trainer.step(loss_sum, pool[k], mm)
        losses.append(out["loss"])
        if k == 0:
            grad = {n: float(g.norm()) for n, g in out["grads"].items()}
    with torch.no_grad():
        change = {n: float((p - initial[n].float()).norm()) for n, p in leaves.items()}
    return {"losses": losses, "grad": grad, "change": change}


def run(ctx) -> harness.Outcome:
    cell, dev = ctx.cell, ctx.device
    tr = cell.traffic
    phases = {"entry": ctx.setup_done()}  # imports and the card's start
    step, weights, state, pool = build(cell, ctx.seed, dev)
    phases["built"] = ctx.setup_done()
    weights, state, program = checked_steps(cell, step, weights, state, pool)
    setup_s = ctx.setup_done()

    n0, done_steps, losses = tr["checked_steps"], 0, []
    with traced(dev, ctx.trace) as trace:
        start = time.perf_counter()
        while True:
            with record_function("chipbench.step"):
                weights, state, metrics = step(weights, state, {"tokens": pool[(n0 + done_steps) % tr["pool_batches"]]})
                losses.append(float(metrics["loss"]))
            done_steps += 1
            done = time.perf_counter()
            if done - start >= ctx.seconds:
                break
    window_s = done - start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del step, weights, state, pool, metrics
    harness.free(dev)

    checked = time.perf_counter()
    numbers = checks.train_numbers(program, reference_steps(cell, ctx.seed, dev))
    check_s = time.perf_counter() - checked
    return harness.Outcome(
        attempted=done_steps, failed=sum(not math.isfinite(x) for x in losses),
        end_to_end={"train_tokens_per_s": done_steps * tr["rows"] * tr["length"] / window_s,
                    "setup_s": setup_s},
        checks=numbers, memory_peak_bytes=memory_peak, units=done_steps, trace=trace(),
        notes={"setup_marks_s": phases, "window_s": window_s, "check_s": check_s, "steps": done_steps, "loss_gap": numbers["loss_gap"],
               "checked_losses": program["losses"], "window_losses": losses[:3] + losses[-1:]},
    )
