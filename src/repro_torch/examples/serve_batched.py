"""Batched serving example: prefill + greedy decode on a reduced model (the
port of ``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched               # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from repro_torch.launch.serve import main as serve_main


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = serve_main(["--arch", "granite-3-8b", "--requests", "8",
                      "--prompt-len", "16", "--gen-len", "24", "--device", args.device])
    assert out["tokens_per_s"] > 0
    print("serve example OK")
    return out


if __name__ == "__main__":
    main()
