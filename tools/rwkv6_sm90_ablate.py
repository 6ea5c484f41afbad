#!/usr/bin/env python3
"""Where the tensor-core RWKV6 kernel's time goes, and what split TF32 buys,
on one CUDA card.

    python3 tools/rwkv6_sm90_ablate.py [--out results.json]
    python3 tools/rwkv6_sm90_ablate.py --phases     # cycles by phase of a chunk
    python3 tools/rwkv6_sm90_ablate.py --mirror     # on the CPU, no card

Builds variants of ``src/repro_torch/kernels/rwkv6/csrc/rwkv6_fwd_sm90.cu``
with one part taken out or changed, each by a text substitution on a copy of
the source (every substitution must apply as many times as stated), compiles
them with ``nvcc`` in parallel into ``build/rwkv6_sm90_ablate/`` and times
each by replaying a CUDA graph of 20 captured calls at rwkv6-3b's serve
shape (B=8, S=512, H=40, P=64) with the bfloat16 r, k, v the model feeds.
Beside each time it prints the variant's max |err| against the plain version
run in float64 on the same inputs, and the share of elements outside
2e-4 + 2e-4 |want|: a variant that leaves work out is wrong by design, but
``tf32x1`` answers whether one TF32 product holds the tolerance.

Variants: ``base``; ``tf32x1`` (one TF32 product, hi.hi: the hi.lo and lo.hi
wgmma calls deleted); ``sub8`` (sub-chunks of 8 steps in place of 16);
``no_diag_exp`` (the diagonal blocks' decay factors set to 1: no
exponentials there); ``no_state`` (no inter-chunk product and no state
update: their wgmma calls deleted); ``loads_only`` (each chunk only waits for
its TMA loads and issues the next: no arithmetic, no stores).

``--phases`` builds a copy of the source in which thread 0 of each block
sums ``clock64()`` cycles over the phases of the chunk loop (TMA wait; scan
and X table; u bonus and kt; the inter, score and diagonal-block loop; V^T;
A.V and the state update; stores and S^T), and the same copy without the
diagonal blocks, and prints each phase's cycles per chunk and block at the
serve shape with bfloat16 r, k, v.  With two blocks on an SM a block's
cycles include the other block's turns.

``--mirror`` runs ``ref.rwkv6_subchunk_reference`` (the kernel's
decomposition in PyTorch) on the CPU at rwkv6's widths (B=1, H=2, S=512,
P=64) with exact, one-TF32 and split-TF32 products, each against the float64
plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src/repro_torch/kernels/rwkv6/csrc/rwkv6_fwd_sm90.cu"
OUT_DIR = REPO / "build" / "rwkv6_sm90_ablate"
SHAPE = (8, 512, 40, 64, 32)  # rwkv6-3b's prompt forward, per layer
MIRROR_SHAPE = (1, 512, 2, 64)  # (B, S, H, P): rwkv6's widths, few heads
TOL = 2e-4


def variants(src: str) -> dict:
    def sub(text, old, new, count=1):
        out, n = re.subn(old, new, text, flags=re.S | re.M)
        if n != count:
            raise RuntimeError(f"substitution applied {n} times, not {count}: {old[:60]!r}")
        return out

    # The hi.lo and lo.hi products of inter, score, intra and state: two each.
    lo_products = (r"^[ \t]*(if \(!EXACT_V\) )?wgmma_rs\([^;\n]*(dsl|dkl|dvl|\]\[4\],)"
                   r"[^;\n]*;[^\n]*\n")
    chunk_work = r"    // \(1\) C = log2\(e\) cumsum.*?// the stage and V\^T are consumed\n"
    return {
        "base": src,
        "tf32x1": sub(src, lo_products, "", count=8),
        "sub8": sub(src, r"constexpr int SUB = 16;", "constexpr int SUB = 8;"),
        "no_diag_exp": sub(src, r"(float diag_decay\(float x\) \{ )return decay\([^;]*\);",
                           r"\1return 1.f;"),
        "no_state": sub(src, r"^[^\n]*wgmma_rs\([^\n]*// (inter|state) [^\n]*\n", "", count=6),
        "loads_only": sub(src, chunk_work, "    __syncthreads();\n"),
    }


def build(srcs: dict) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import ops

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        so = OUT_DIR / f"lib{name}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-4000:]}")
        regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers", log)})
        spills = sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores", log)})
        print(f"variant {name}: registers {regs}, spill stores {spills} bytes", flush=True)
        libs[name] = ops.bind(ctypes.CDLL(str(so)))
    return libs


def errors(got, want) -> tuple:
    """(max |err|, share of elements outside TOL + TOL |want|) over out and state."""
    errs = [(g.double() - w).abs() for g, w in zip(got, want)]
    bad = sum(int((e > TOL + TOL * w.abs()).sum()) for e, w in zip(errs, want))
    return max(float(e.max()) for e in errs), bad / sum(w.numel() for w in want)


PHASES = ["tma wait", "scan, X", "u bonus, kt", "inter, scores, diagonal", "V^T",
          "A.V, state update", "stores, S^T"]


def phase_variants(src: str) -> dict:
    """The source with per-phase cycle counters (summed into a device array
    read by ``rwkv6_phases``), with and without the diagonal blocks."""
    def rep(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"anchor found {text.count(old)} times, not once: {old[:60]!r}")
        return text.replace(old, new)

    def mark(k):
        return (f"    if (tid == 0) {{ const long long now = clock64(); ph[{k}] += now - last; "
                f"last = now; }}\n")

    s = rep(src, "namespace {\n\nconstexpr int L = 64;",
            "__device__ unsigned long long g_phase[8];\nnamespace {\n\nconstexpr int L = 64;")
    s = rep(s, "  float st[32];", "  long long ph[8] = {}, last = clock64();\n  float st[32];")
    s = rep(s, "    mbar_wait(full + 8 * s, (c / M::NSTAGE) & 1);\n",
            "    mbar_wait(full + 8 * s, (c / M::NSTAGE) & 1);\n" + mark(0))
    for k, anchor in enumerate(["    // (2) kt = k", "    // (3) On the tensor cores", "    // (4) V^T",
                                "    // (5) intra = A . V", "    // (6) The output"], start=1):
        s = rep(s, anchor, mark(k) + anchor)
    s = rep(s, "    fence_async_smem();\n  }\n\n  // The final state",
            "    fence_async_smem();\n" + mark(6) + "  }\n  if (tid == 0)\n"
            "    for (int k = 0; k < 8; ++k) atomicAdd(&g_phase[k], (unsigned long long)ph[k]);\n"
            "\n  // The final state")
    s += ('\nextern "C" int rwkv6_phases(unsigned long long* host) {\n'
          "  cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n"
          "  unsigned long long zero[8] = {};\n"
          "  return cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));\n}\n")
    diag = "for (int p = 8 * kk + 8 * wv / NWAVE; p < 8 * kk + 8 * (wv + 1) / NWAVE; p += 4) {"
    return {"phases": s, "phases_no_diag": rep(s, diag, "for (int p = 0; p < 0; p += 4) {")}


def phases() -> dict:
    import torch
    from chip_smoke import graph_ms, rwkv6_inputs
    from repro_torch.kernels.rwkv6 import ops

    libs = build(phase_variants(SOURCE.read_text()))
    B, S, H = SHAPE[:3]
    inputs = rwkv6_inputs(SHAPE, torch.bfloat16, torch.Generator(device="cuda").manual_seed(0))
    rows = {}
    for name, lib in libs.items():
        lib.rwkv6_phases.argtypes = [ctypes.c_void_p]
        ops._kernel = lambda: lib
        buf = (ctypes.c_ulonglong * 8)()
        ops.rwkv6_mix(*inputs, chunk=SHAPE[4])
        torch.cuda.synchronize()
        lib.rwkv6_phases(buf)  # drop the first call's counts
        calls = 5
        for _ in range(calls):
            ops.rwkv6_mix(*inputs, chunk=SHAPE[4])
        torch.cuda.synchronize()
        lib.rwkv6_phases(buf)
        per = calls * B * H * ((S + 63) // 64)
        cycles = {ph: buf[i] / per for i, ph in enumerate(PHASES)}
        rows[name] = {"cycles_per_chunk": cycles, "ms": graph_ms(lambda: ops.rwkv6_mix(
            *inputs, chunk=SHAPE[4]))}
        print(f"{name}: {rows[name]['ms']:.4f} ms graph-replayed (with counters); cycles per chunk "
              f"and block, thread 0: " + ", ".join(f"{k} {v:.0f}" for k, v in cycles.items())
              + f"; total {sum(cycles.values()):.0f}", flush=True)
    return rows


def mirror() -> int:
    import torch

    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels.rwkv6 import ref

    B, S, H, P = MIRROR_SHAPE
    gen = torch.Generator().manual_seed(0)
    rn = lambda *shape: torch.randn(*shape, generator=gen)
    for logw in (None, -5.0):
        r, k, v = (rn(B, H, S, P) for _ in range(3))
        lw = -torch.exp(rn(B, H, S, P) - 1.0) if logw is None else torch.full((B, H, S, P), logw)
        u = rn(H, P) * 0.1
        want = ref.rwkv6_reference(*(t.double() for t in (r, k, v, lw, u)))
        for sub in (16, 8):
            for tf32 in (None, "one", "split"):
                got = ref.rwkv6_subchunk_reference(r, k, v, lw, u, sub=sub, tf32=tf32)
                err, share = errors(got, want)
                print(f"mirror (B, S, H, P) = {MIRROR_SHAPE}, logw {logw or '-exp(N(0,1) - 1)'}, "
                      f"sub-chunk {sub}, products {tf32 or 'exact float32'}: max |err| {err:.3g} "
                      f"(max |want| {max(float(w.abs().max()) for w in want):.3g}), {share:.4f} "
                      f"of elements outside {TOL:g} + {TOL:g} |want|", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    ap.add_argument("--mirror", action="store_true", help="the CPU mirror's errors; no card")
    ap.add_argument("--phases", action="store_true", help="cycles by phase of the chunk loop")
    args = ap.parse_args()
    if args.mirror:
        return mirror()
    import torch

    if not torch.cuda.is_available():
        print("rwkv6_sm90_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    from chip_smoke import as_float64, graph_ms, rwkv6_inputs, rwkv6_plain
    from repro_torch.kernels.rwkv6 import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.phases:
        rows = phases()
        if args.out:
            args.out.write_text(json.dumps({"device": smi, "shape": SHAPE, "phases": rows}, indent=1))
        return 0
    libs = build(variants(SOURCE.read_text()))
    inputs = rwkv6_inputs(SHAPE, torch.bfloat16, torch.Generator(device="cuda").manual_seed(0))
    want = rwkv6_plain(*as_float64(inputs))

    def run(name):
        ops._kernel = lambda: libs[name]  # the wrapper launches this variant
        return ops.rwkv6_mix(*inputs, chunk=SHAPE[4])

    rows = {}
    for name in libs:
        got = run(name)
        torch.cuda.synchronize()
        err, share = errors(got, want)
        r = rows[name] = {"ms": graph_ms(lambda: run(name)), "max_abs_err": err,
                          "share_out_of_tol": share}
        print(f"{name}: {r['ms']:.4f} ms graph-replayed; vs float64 plain version: max |err| "
              f"{err:.3g}, {share:.4f} of elements outside {TOL:g} + {TOL:g} |want|", flush=True)
    if args.out:
        args.out.write_text(json.dumps({"device": smi, "shape": SHAPE, "variants": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
