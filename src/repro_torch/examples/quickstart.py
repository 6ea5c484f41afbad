"""Quickstart: train a reduced LM for 60 steps and watch the loss drop (the
port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

from repro_torch.launch.train import main as train_main


def main(argv: Optional[List[str]] = None) -> Tuple[float, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    first, last = train_main(
        ["--arch", "granite-3-8b", "--steps", str(args.steps), "--batch", "8",
         "--seq", "64", "--lr", "3e-3", "--log-every", "10", "--device", args.device]
    )
    assert last < first, "loss did not decrease"
    print(f"quickstart OK: {first:.3f} -> {last:.3f}")
    return first, last


if __name__ == "__main__":
    main()
