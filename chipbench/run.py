"""The benchmark's one command.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card: set-up (weights and
prompts made on the card from the seed, the kernels built into
``build/repro_torch_kernels/`` at the first run in a checkout, the cell's
shapes warmed up), the measured window, the comparison with the plain
reference; then prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``
and, traced, ``breakdown``; last in it, ``checks``: each compared number
with its limit, which also end standard error.  Exits non-zero with no
result when there is no card, too few cards, the program is missing, or the
JAX stack was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Caches of compilers the program or torch may call, inside the checkout
    # at fixed paths (the kernels' own are in build/repro_torch_kernels).
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(ROOT / "build" / "chipbench" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    imported = time.perf_counter() - T0
    from chipbench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"chipbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chipbench: the program is missing: no {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 4

    torch.zeros(1, device="cuda")  # the card's context, so the mark below includes it
    print(f"chipbench: torch imported at {imported:.3f} s, the card started at {time.perf_counter() - T0:.3f} s",
          file=sys.stderr)
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T0)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"chipbench: the JAX stack or package was loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
