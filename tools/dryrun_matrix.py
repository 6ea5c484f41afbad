"""PERF.md's table of dry-run records.

The matrix runs on the card through the CLI, in pieces that each fit one
call (``--part i/n`` runs every n-th arch x shape pair from the i-th, each
mesh in a child process whose wall time the CLI writes into the record as
``child_seconds``); a cell whose checks fail is not ``ok`` and fails the
CLI.  This script renders the records it wrote (``build/dryrun/*.json``)
as one row per arch x shape, single-pod and multi-pod values separated by
" // " ("-": no record): the three roofline terms and the bottleneck, the
collective bytes and ops by axis, the view replications, the run and
calibration seconds and the child's, the state bytes and the peak
allocated bytes.

Usage:
  python -m repro_torch.launch.dryrun --all --mesh both --link-bw 50e9 --device cuda --force --part 1/3
  python3 tools/dryrun_matrix.py build/dryrun/*.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def table(paths) -> str:
    """The table of the records in ``paths`` (a later record of a cell wins)."""
    rows = {}
    for path in paths:
        r = json.loads(Path(path).read_text())
        rows[(r["arch"], r["shape"], r["mesh"])] = r
    g = lambda x: f"{x:.4g}"
    out = ["| Cell | Compute / memory / collective s; bottleneck | Collective bytes by axis (ops) | View "
           "replications | Run + calibration; child s | State B; peak allocated B |", "|---|---|---|---|---|---|"]
    for arch, shape in sorted({(a, s) for a, s, _ in rows}):
        cells = [rows.get((arch, shape, m)) for m in ("single", "multi")]
        fmt = lambda f: " // ".join("-" if r is None else f(r) for r in cells)
        axes = lambda r: ", ".join(f"{ax} {g(v['bytes'])} ({round(v['count'])})"
                                   for ax, v in sorted(r["per_axis_collectives"].items()))
        repl = lambda r: ", ".join(f"{k} {v}" for k, v in sorted(r["view_replications"].items())) or "0"
        state = lambda r: (f"{r['bytes_per_device']:.0f}; {r['memory_analysis'].get('peak_allocated_bytes')}"
                           + ("" if r["ok"] else " FAIL"))
        out.append(f"| {arch} x {shape} | "
                   + fmt(lambda r: f"{g(r['compute_term'])} / {g(r['memory_term'])} / "
                                   f"{g(r['collective_term'])}, {r['bottleneck']}") + " | "
                   + fmt(axes) + " | " + fmt(repl) + " | "
                   + fmt(lambda r: f"{r['lower_seconds']} + {r['compile_seconds']}; {r.get('child_seconds')}")
                   + " | " + fmt(state) + " |")
    return "\n".join(out)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    print(table(sys.argv[1:]))
