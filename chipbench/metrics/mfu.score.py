"""mfu.score: the model operations of the prompt forwards finished in the
traced window (``chipbench.flops.score_flops``: the last position's logits
only) over the window's time and the card's bfloat16 peak, in %."""

from chipbench import flops


def read(run):
    if run.peaks is None or run.units == 0:
        return None
    tr = run.cell.traffic
    work = run.units * flops.score_flops(run.cell.cfg, tr["rows"], tr["length"])
    return 100 * work / run.trace.window_s / run.peaks["bf16_flops"]
