#!/usr/bin/env python3
"""Warm prompt-forward device time of each served family, for two or more
checkouts of the repository in turn, on one CUDA card.

    python3 tools/prompt_forward_ab.py PARENT . . PARENT

Each argument is the root of a checkout (for example a ``git archive`` of
the parent commit unpacked into the git-ignored ``build/``); each runs in a
process of its own, in the order given, with that checkout's kernels
(built into its own ``build/``) and its own ``chip_smoke.py`` helpers.  For
granite-3-8b, zamba2-2.7b and rwkv6-3b it prints what ``chip_smoke.py``
phase 4 measures: the device busy time and wall time of one warm prompt
forward of 8 x 512 tokens through the kernels, and the three kernels that
take the most device time.  Two versions are compared only within one
call, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def one(root: Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    for arch in chip_smoke.SERVE_ARCHS:
        torch.cuda.empty_cache()
        cfg = get_arch(arch)
        params = build_model(cfg).init(1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (8, 512), device="cuda", generator=gen)
        r = chip_smoke.profile_prompt_forward(build_model(cfg, impl="kernel"), params, prompts)
        top = ", ".join(f"{name} {ms:.3f} ms" for name, ms in r["top_kernels_ms"][:3])
        print(f"{root} {arch}: prompt forward device busy {r['device_busy_ms']:.3f} ms, wall "
              f"{r['wall_ms']:.3f} ms; top: {top}", flush=True)
        del params


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", root])
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
