"""The ``score`` entry: prompts through the program's prompt forward
(``make_prefill_step`` on a model built with ``impl="kernel"``, which runs
every hand-written kernel the family has), one batch in flight.

A batch is one request of each of its rows, issued at once; a request's
latency runs from the batch's issue to its last-position logits being on
the host.  The loop is closed: the next batch is issued when the last one's
answers are in.  The window runs whole batches until ``--seconds`` have
passed, and its time is that of those batches.

Traffic keys: ``rows``, ``length``, ``pool_batches`` (distinct batches
drawn; the window cycles through them), ``warmup_batches``, ``check_rows``
(requests compared with the reference, drawn from the seed among those the
window finished), ``reference_rows`` (rows the reference runs at once).
"""

from __future__ import annotations

import random
import statistics
import time
from typing import List

import torch
from torch.profiler import record_function

from chipbench import checks, harness
from chipbench.reference.plain import exact_mm, set_exact_float32
from chipbench.trace import traced


def build(cell, seed: int, device):
    """(weights, token pool, prefill) as the window uses them."""
    from repro_torch.models import model as model_lib
    from repro_torch.train import steps

    fam = harness.family(cell.cfg)
    weights = fam.init_weights(cell.cfg, harness.subseed(seed, "weights"), device)
    pool = harness.token_pool(cell.cfg, cell.traffic, seed, device)
    model = model_lib.build_model(harness.arch_config(cell.cfg), impl="kernel")
    return weights, pool, steps.make_prefill_step(model)


def batch_index(cell, j: int) -> int:
    """The pool batch that the window's j-th batch sends."""
    return (cell.traffic["warmup_batches"] + j) % cell.traffic["pool_batches"]


def picks(cell, seed: int, batches: int) -> List[tuple]:
    """The (window batch, row) pairs compared, drawn from the seed among the
    requests of ``batches`` finished batches."""
    R = cell.traffic["rows"]
    rng = random.Random(harness.subseed(seed, "sample"))
    chosen = rng.sample(range(batches * R), min(cell.traffic["check_rows"], batches * R))
    return sorted(divmod(i, R) for i in chosen)


def reference_logits(cell, seed: int, pairs, device, mm=exact_mm) -> torch.Tensor:
    """The reference's float32 last-position logits of the requests
    ``pairs``, from weights and prompts made again from the seed."""
    set_exact_float32()
    fam = harness.family(cell.cfg)
    weights = fam.init_weights(cell.cfg, harness.subseed(seed, "weights"), device)
    pool = harness.token_pool(cell.cfg, cell.traffic, seed, device)
    tokens = torch.stack([pool[batch_index(cell, b), r] for b, r in pairs])
    del pool
    n = cell.traffic["reference_rows"]
    out = [fam.last_logits(weights, cell.cfg, tokens[i : i + n], mm) for i in range(0, len(tokens), n)]
    return torch.cat(out)


def run(ctx) -> harness.Outcome:
    cell, dev = ctx.cell, ctx.device
    tr = cell.traffic
    R, S, V = tr["rows"], tr["length"], cell.cfg["vocab_size"]
    phases = {"entry": ctx.setup_done()}  # imports and the card's start
    weights, pool, prefill = build(cell, ctx.seed, dev)
    phases["built"] = ctx.setup_done()
    for i in range(tr["warmup_batches"]):
        prefill(weights, {"tokens": pool[i]}).to("cpu")
    setup_s = ctx.setup_done()

    answers, latency = [], []
    with traced(dev, ctx.trace) as trace:
        start = time.perf_counter()
        while True:
            with record_function("chipbench.batch"):
                tokens = pool[batch_index(cell, len(answers))]
                issued = time.perf_counter()
                logits = prefill(weights, {"tokens": tokens}).to("cpu")
                done = time.perf_counter()
            answers.append(logits)
            latency.append(done - issued)
            if done - start >= ctx.seconds:
                break
    window_s = done - start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del weights, pool, prefill
    harness.free(dev)

    checked = time.perf_counter()
    pairs = picks(cell, ctx.seed, len(answers))
    program = torch.stack([answers[b][r, :V].float() for b, r in pairs]).to(dev)
    numbers = checks.logit_numbers(program, reference_logits(cell, ctx.seed, pairs, dev))
    check_s = time.perf_counter() - checked
    failed = sum(int((~torch.isfinite(a.float())).any(dim=-1).sum()) for a in answers)
    per_request_ms = [t * 1e3 for t in latency for _ in range(R)]
    return harness.Outcome(
        attempted=len(answers) * R, failed=failed,
        end_to_end={
            "score_tokens_per_s": len(answers) * R * S / window_s,
            "score_latency_p95_ms": statistics.quantiles(per_request_ms, n=20, method="inclusive")[-1],
            "setup_s": setup_s,
        },
        checks=numbers, memory_peak_bytes=memory_peak, units=len(answers), trace=trace(),
        notes={"setup_marks_s": phases, "window_s": window_s, "check_s": check_s, "batches": len(answers),
               "latency_median_ms": statistics.median(per_request_ms)},
    )
