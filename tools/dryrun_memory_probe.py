"""Where one dry-run cell's memory goes on the card.

Runs the cell's production run (``run_cell`` without calibration) with the
CUDA allocator's history recorded and prints, at the end of each
microbatch's forward pass, the bytes allocated then and the most allocated
since the last such point (the previous microbatch's backward pass
included); at an out-of-memory error, the live blocks grouped by the first
``repro_torch`` frame that allocated them, and otherwise the blocks still
live at the end.

    PYTHONPATH=src python3 tools/dryrun_memory_probe.py nemotron-4-340b train_4k single
"""
import collections
import json
import sys
import time

import torch

GiB = 2**30


def by_frame(snap, top=25):
    """Active blocks of an allocator snapshot, summed by the first
    repro_torch frame that allocated them, largest first (GiB)."""
    acc = collections.Counter()
    for seg in snap["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = blk.get("frames") or []
            key = next((f"{f['filename'].split('src/')[-1]}:{f['line']} {f['name']}" for f in frames
                        if "repro_torch" in f["filename"]), "<no repro_torch frame>")
            acc[key] += blk["size"]
    return [(k, round(v / GiB, 3)) for k, v in acc.most_common(top)]


def main() -> None:
    arch_name, shape_name, mesh_kind = sys.argv[1:4]
    torch.cuda.memory._record_memory_history(max_entries=200000, stacks="python", context="alloc")
    done = {}

    def on_oom(device, alloc, device_alloc, device_free):
        done["oom"] = {"allocated_GiB": torch.cuda.memory_allocated() / GiB, "request_GiB": alloc / GiB,
                       "by_frame": by_frame(torch.cuda.memory._snapshot())}

    torch._C._cuda_attach_out_of_memory_observer(on_oom)
    from repro_torch.launch import dryrun
    from repro_torch.models import rwkv_lm, transformer, zamba

    phases = []
    for mod in (transformer, zamba, rwkv_lm):
        def wrapped(*a, _f=mod.forward, **k):
            out = _f(*a, **k)
            phases.append(("forward end", torch.cuda.memory_allocated() / GiB,
                           torch.cuda.max_memory_allocated() / GiB))
            torch.cuda.reset_peak_memory_stats()
            return out
        mod.forward = wrapped
    t0 = time.time()
    try:
        rec = dryrun.run_cell(arch_name, shape_name, mesh_kind, link_bw=50e9, force=True, skip_calibration=True)
        print("ran", rec["ok"], rec["memory_analysis"], flush=True)
    except torch.OutOfMemoryError as e:
        print("OOM", str(e)[:300], flush=True)
    print(json.dumps({"cell": f"{arch_name} x {shape_name} x {mesh_kind}", "seconds": round(time.time() - t0, 1),
                      "phases": phases, "oom": done.get("oom")}, indent=1), flush=True)
    if "oom" not in done:
        print("live at the end:", json.dumps(by_frame(torch.cuda.memory._snapshot())), flush=True)


if __name__ == "__main__":
    main()
