"""The dry-run's hill-climb on the card: the three cells of
``benchmarks/perf_hillclimb.py`` under one of its variants, through the
port's dry-run (``repro_torch.launch.dryrun.run_cell``), with calibration.

``CELLS`` and ``VARIANTS`` are the JAX script's, verbatim (kept in
``repro_torch.launch.dryrun`` as ``HILLCLIMB_CELLS`` and
``HILLCLIMB_VARIANTS``): ``baseline2``
re-measures the paper-faithful configuration, ``opt1``-``opt4`` trade
microbatches, ``remat="dots"``, a chunked CE, ZeRO-1 and (rwkv6-3b's
``opt4``) pure 256-way data parallelism with no model axis.  Each record
goes to ``build/dryrun/{arch}__{shape}__{mesh}__{tag}.json``, with the
cell's wall seconds (``wall_seconds``).  A cell whose
run does not fit the card's memory is recorded ``ok: false`` with its
out-of-memory error and printed ``[OOM]``; the script exits non-zero when
any record is not ``ok``.

Usage (on the card; never a full-size cell on a CPU):
  python3 tools/perf_hillclimb.py --variant opt1 --link-bw 50e9 --force
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.dryrun import HILLCLIMB_CELLS as CELLS  # noqa: E402
from repro_torch.launch.dryrun import HILLCLIMB_VARIANTS as VARIANTS  # noqa: E402
from repro_torch.launch.dryrun import hillclimb_variant as variant_of  # noqa: E402
from repro_torch.launch.dryrun import record_path, run_cell  # noqa: E402


def line(name: str, rec: dict) -> str:
    """JAX's line for a cell, with the peak allocated bytes; an
    out-of-memory record is marked ``[OOM]``."""
    mem = rec["memory_analysis"]
    head = f"[{name}] {rec['arch']} x {rec['shape']}: "
    if rec.get("out_of_memory"):
        oom = rec["out_of_memory"]
        return (head + f"[OOM] C={rec['compute_term']:.1f}s M={rec['memory_term']:.1f}s "
                f"state={rec['bytes_per_device']:.0f}B allocated={oom.get('allocated_bytes')}B "
                f"request={oom.get('request_bytes')}B; {oom['error']}")
    return (head + f"C={rec['compute_term']:.1f}s M={rec['memory_term']:.1f}s "
            f"K={rec['collective_term']:.1f}s frac={rec['roofline_fraction']:.4f} "
            f"peak={mem.get('peak_allocated_bytes', 0) / 1e9:.1f}GB"
            + ("" if rec["ok"] else " FAIL " + "; ".join(rec["checks"])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="baseline2", choices=sorted(VARIANTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--link-bw", type=float, required=True,
                    help="bytes per second of one link, the collective term's rate")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch

    failed = []
    for arch, shape, mesh in CELLS:
        variant = variant_of(args.variant, arch)
        path = record_path(arch, shape, mesh, variant)
        fresh = args.force or not path.exists()
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, mesh, link_bw=args.link_bw, force=args.force, device=args.device,
                       variant=variant)
        if fresh:
            rec["wall_seconds"] = round(time.perf_counter() - t0, 1)
            path.write_text(json.dumps(rec, indent=1))
        print(line(args.variant, rec), flush=True)
        for ax, st in sorted((rec.get("per_axis_collectives") or {}).items()):
            if st["bytes"] > 1e9:
                print(f"     axis {ax:12s} bytes={st['bytes']:.3e} ({st['bytes'] / args.link_bw:.1f}s @1link)")
        print(json.dumps({"cell": f"{arch} x {shape} x {mesh}", "variant": rec["variant"],
                          "run_s": rec["lower_seconds"], "calibration_s": rec["compile_seconds"],
                          "wall_s": rec.get("wall_seconds")}), flush=True)
        if not rec["ok"]:
            failed.append(f"{arch} x {shape} x {mesh}")
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if failed:
        print(f"{len(failed)} cell(s) not ok: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
