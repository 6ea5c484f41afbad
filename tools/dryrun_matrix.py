"""PERF.md's tables of dry-run records.

The matrix runs on the card through the CLI, in pieces that each fit one
call (``--part i/n`` runs every n-th arch x shape pair from the i-th, each
mesh in a child process whose wall time the CLI writes into the record as
``child_seconds``); a cell whose checks fail is not ``ok`` and fails the
CLI.  This script renders the records it wrote (``build/dryrun/*.json``)
as one row per arch x shape, single-pod and multi-pod values separated by
" // " ("-": no record): the three roofline terms and the bottleneck, the
collective bytes and ops by axis, the view replications, the run and
calibration seconds and the child's, the state bytes and the peak
allocated bytes.  A variant's record (``..._{tag}.json``, a ``tag`` in its
``variant``) is left out of that table, as JAX's ``load_records`` leaves
it out; ``--variants`` renders the variants' records instead, one row per
arch x shape x mesh x tag (``tools/perf_hillclimb.py`` writes them), an
out-of-memory record marked ``OOM`` with the bytes allocated when it
failed.

Usage:
  python -m repro_torch.launch.dryrun --all --mesh both --link-bw 50e9 --device cuda --force --part 1/3
  python3 tools/dryrun_matrix.py build/dryrun/*.json
  python3 tools/dryrun_matrix.py --variants build/dryrun/*.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

g = lambda x: "-" if x is None else f"{x:.4g}"


def _tag(r) -> str:
    return (r.get("variant") or {}).get("tag") or ""


def load(paths):
    """The records in ``paths`` by (arch, shape, mesh, tag), a later record
    of a cell winning; the tag is "" for a record of no variant."""
    rows = {}
    for path in paths:
        r = json.loads(Path(path).read_text())
        rows[(r["arch"], r["shape"], r["mesh"], _tag(r))] = r
    return rows


def _terms(r) -> str:
    return f"{g(r['compute_term'])} / {g(r['memory_term'])} / {g(r['collective_term'])}, {r['bottleneck']}"


def _axes(r) -> str:
    if r["per_axis_collectives"] is None:
        return "-"
    return ", ".join(f"{ax} {g(v['bytes'])} ({round(v['count'])})"
                     for ax, v in sorted(r["per_axis_collectives"].items()))


def table(paths) -> str:
    """The table of the records in ``paths`` that are of no variant."""
    rows = {k[:3]: r for k, r in load(paths).items() if not k[3]}
    out = ["| Cell | Compute / memory / collective s; bottleneck | Collective bytes by axis (ops) | View "
           "replications | Run + calibration; child s | State B; peak allocated B |", "|---|---|---|---|---|---|"]
    for arch, shape in sorted({(a, s) for a, s, _ in rows}):
        cells = [rows.get((arch, shape, m)) for m in ("single", "multi")]
        fmt = lambda f: " // ".join("-" if r is None else f(r) for r in cells)
        repl = lambda r: ", ".join(f"{k} {v}" for k, v in sorted(r["view_replications"].items())) or "0"
        state = lambda r: (f"{r['bytes_per_device']:.0f}; {r['memory_analysis'].get('peak_allocated_bytes')}"
                           + ("" if r["ok"] else " FAIL"))
        out.append(f"| {arch} x {shape} | " + fmt(_terms) + " | " + fmt(_axes) + " | " + fmt(repl) + " | "
                   + fmt(lambda r: f"{r['lower_seconds']} + {r['compile_seconds']}; {r.get('child_seconds')}")
                   + " | " + fmt(state) + " |")
    return "\n".join(out)


def variant_table(paths) -> str:
    """One row per variant record in ``paths``: its knobs, the three terms
    and the bottleneck, bytes and ops by axis, state and peak allocated
    bytes (an out-of-memory record: the bytes allocated when it failed and
    the request), and the run, calibration and wall seconds."""
    rows = {k: r for k, r in load(paths).items() if k[3]}
    out = ["| Cell | Variant | Compute / memory / collective s; bottleneck | Collective bytes by axis (ops) "
           "| State B; peak allocated B | Run + calibration; wall s |", "|---|---|---|---|---|---|"]
    for (arch, shape, mesh, tag), r in sorted(rows.items(), key=lambda kv: (kv[0][3], kv[0][:3])):
        knobs = ", ".join(f"{k} {v}" for k, v in r["variant"].items() if k != "tag")
        mem = r["memory_analysis"]
        if r.get("out_of_memory"):
            oom = r["out_of_memory"]
            memory = (f"{r['bytes_per_device']:.0f}; OOM at {oom.get('allocated_bytes')} allocated, "
                      f"request {oom.get('request_bytes')}")
        else:
            memory = f"{r['bytes_per_device']:.0f}; {mem.get('peak_allocated_bytes')}" + ("" if r["ok"] else " FAIL")
        out.append(f"| {arch} x {shape} x {mesh} | {tag}: {knobs} | {_terms(r)} | {_axes(r)} | {memory} | "
                   f"{r['lower_seconds']} + {r['compile_seconds']}; {r.get('wall_seconds')} |")
    return "\n".join(out)


if __name__ == "__main__":
    args = sys.argv[1:]
    variants = "--variants" in args
    paths = [a for a in args if a != "--variants"]
    if not paths:
        raise SystemExit(__doc__)
    print(variant_table(paths) if variants else table(paths))
