"""Fault-tolerant training: checkpoint, injected failure, restore, resume
(the port of ``examples/fault_tolerant_training.py``).

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training               # on the card
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training --device cpu

``--steps`` (60) scales the run: a checkpoint every sixth of it, the
failure at 25/60 of it, and the resumed run to 4/3 of it, as the JAX
example's 10, 25 and 80 of 60.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Tuple

from repro_torch.launch.train import main as train_main


def main(argv: Optional[List[str]] = None) -> Tuple[float, float, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.steps
    common = ["--arch", "granite-3-8b", "--batch", "4", "--seq", "32", "--log-every", "10",
              "--device", args.device]
    with tempfile.TemporaryDirectory() as d:
        first, last = train_main(
            common + ["--steps", str(n), "--ckpt-dir", d, "--ckpt-every", str(max(n // 6, 1)),
                      "--simulate-failure-at", str(n * 25 // 60)]
        )
        # resume from the final checkpoint and continue
        _, last2 = train_main(common + ["--steps", str(n * 4 // 3), "--ckpt-dir", d, "--resume"])
    assert last < first
    print(f"fault-tolerant run OK: {first:.3f} -> {last:.3f}, resumed -> {last2:.3f}")
    return first, last, last2


if __name__ == "__main__":
    main()
