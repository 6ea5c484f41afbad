"""The numbers that decide ``correct``: what the program produced against
the plain reference's float32 answer.

Scoring (one answer a request: the logits at the last prompt position):

* ``logit_rms``: over the sampled requests, the largest RMS of the
  program's logits less the reference's, over the RMS of the reference's
  logits about their mean (the logits' spread);
* ``top1_gap``: over the same requests, the largest gap by which the
  reference's logit of the program's top token lies below the reference's
  best, in units of the reference's spread.

Training (the steps that set-up drives, which the reference follows):

* ``loss_gap``: the largest gap between the program's and the reference's
  mean loss of a step, over the reference's;
* ``grad_gap``: by the worst leaf, the gap between the norm of the
  program's first clipped gradient (read from AdamW's first moment after
  one step) and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``change_gap``: the same for the norm of each leaf's change over the
  steps followed.

A cell compares the numbers that its ``chipbench/limits/<cell>.json``
gives a limit; the others are read and printed (``loss_gap`` has no
reading from the control or a fault that separates it from the
program's, so no limit could hold).  A leaf is a stacked leaf's slice of
one layer.  Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of both
(a gradient that is nought to rounding moves under Adam by round-off).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Tuple

import torch

EXCLUDE_BELOW = 1e-3


def logit_numbers(program: torch.Tensor, reference: torch.Tensor) -> Dict[str, float]:
    """program, reference: (requests, V) float32 logits."""
    spread = reference - reference.mean(dim=-1, keepdim=True)
    scale = spread.pow(2).mean(dim=-1).sqrt()
    rms = (program - reference).pow(2).mean(dim=-1).sqrt() / scale
    best = reference.max(dim=-1).values
    picked = reference.gather(-1, program.argmax(dim=-1, keepdim=True))[:, 0]
    return {"logit_rms": float(rms.max()), "top1_gap": float(((best - picked) / scale).max())}


def norm_gap(program: Dict[str, float], reference: Dict[str, float], kept) -> float:
    """The worst leaf's gap between two per-leaf norms, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(reference[k] for k in kept)
    return max(abs(program[k] - reference[k]) / max(reference[k], med) for k in kept)


def kept_leaves(ref_grad: Dict[str, float]):
    med = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= EXCLUDE_BELOW * med)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"losses": [...], "grad": {leaf: norm}, "change": {leaf: norm}}
    over the same steps."""
    kept = kept_leaves(ref["grad"])
    n = len(ref["losses"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"][:n], ref["losses"])),
        "grad_gap": norm_gap(prog["grad"], ref["grad"], kept),
        "change_gap": norm_gap(prog["change"], ref["change"], kept),
    }


def leaf_norms(pairs: Iterable[Tuple[str, torch.Tensor]], stacked: str = "layers") -> Dict[str, float]:
    """The float32 norm of each leaf, a leaf under ``stacked`` split into its
    layers ("layers/3/attn/wq").  ``pairs``: ("layers/attn/wq", tensor), ...
    (a generator keeps one float32 temporary at a time)."""
    out = {}
    for name, t in pairs:
        head, _, rest = name.partition("/")
        if head == stacked:
            for i in range(t.shape[0]):
                out[f"{head}/{i}/{rest}"] = float(t[i].float().norm())
        else:
            out[name] = float(t.float().norm())
    return out
