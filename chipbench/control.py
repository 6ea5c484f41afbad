"""The readings that a cell's limits are set from, on the card at the cell's
own sizes, in one process:

    python3 chipbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

For each seed of ``--seeds`` the program's reading: the cell's timed entry
at its timed sizes against the plain reference, as a run compares them
(score cells: as many requests as a run compares, drawn from ``--batches``
batches at the cell's size; train cells: the checked steps).  For each seed of ``--control-seeds`` the
control's: the reference computed with every product's operands rounded to
float8 e4m3 (``reference.plain.fp8_mm``), put in the program's place; and,
for a train cell, the fault "half of the batch left out, the mean taken
over the rest", planted in the program.  One JSON line per reading.  The
benchmark's own runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def score_readings(cell, seed, device, batches: int, control: bool):
    import torch

    from chipbench import checks, harness
    from chipbench.entries import score
    from chipbench.reference.plain import fp8_mm

    pairs = score.picks(cell, seed, batches)
    weights, pool, prefill = score.build(cell, seed, device)
    answers = {}
    for b in sorted({b for b, _ in pairs}):
        answers[b] = prefill(weights, {"tokens": pool[score.batch_index(cell, b)]}).to("cpu")
    V = cell.cfg["vocab_size"]
    program = torch.stack([answers[b][r, :V].float() for b, r in pairs]).to(device)
    del weights, pool, prefill
    harness.free(device)
    ref = score.reference_logits(cell, seed, pairs, device)
    out = [("program", checks.logit_numbers(program, ref))]
    if control:
        out.append(("control_fp8", checks.logit_numbers(score.reference_logits(cell, seed, pairs, device, fp8_mm), ref)))
    return out


def train_readings(cell, seed, device, batches: int, control: bool):
    from chipbench import checks, harness
    from chipbench.entries import train
    from chipbench.reference.plain import fp8_mm

    def program(fault=None):
        step, weights, state, pool = train.build(cell, seed, device)
        if fault == "half_batch":
            half = cell.traffic["rows"] // 2
            whole = step
            step = lambda w, s, b: whole(w, s, {"tokens": b["tokens"][:half]})
        _, _, readings = train.checked_steps(cell, step, weights, state, pool)
        del step, weights, state, pool
        harness.free(device)
        return readings

    prog = program()
    ref = train.reference_steps(cell, seed, device)
    harness.free(device)
    out = [("program", checks.train_numbers(prog, ref))]
    if control:
        out.append(("control_fp8", checks.train_numbers(train.reference_steps(cell, seed, device, fp8_mm), ref)))
        harness.free(device)
        out.append(("fault_half_batch", checks.train_numbers(program("half_batch"), ref)))
    out.append(("losses", {"program": prog["losses"], "reference": ref["losses"]}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--batches", type=int, default=1, help="batches, each at the cell's size, a score reading draws its requests from")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from chipbench import harness

    if not torch.cuda.is_available():
        print("chipbench control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.resolve(args.workload)
    readings = {"score": score_readings, "train": train_readings}[cell.traffic["entry"]]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(controls - {int(s) for s in args.seeds.split(",")})
    for seed in seeds:
        t = time.perf_counter()
        for side, numbers in readings(cell, seed, device, args.batches, seed in controls):
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side, **numbers,
                              "seconds": round(time.perf_counter() - t, 1)}), flush=True)
    print(json.dumps({"workload": cell.name, "device": torch.cuda.get_device_name(device),
                      "total_s": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
