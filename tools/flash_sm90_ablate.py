#!/usr/bin/env python3
"""Where the bf16 tensor-core flash kernel's time goes, on one CUDA card.

    python3 tools/flash_sm90_ablate.py [--out results.json]

Builds variants of ``src/repro_torch/kernels/attention/csrc/flash_fwd_sm90.cu``
with one part taken out, each by a text substitution on a copy of the
source (every substitution must apply), compiles them with ``nvcc`` in
parallel into ``build/flash_sm90_ablate/`` and times each, beside PyTorch's
``scaled_dot_product_attention``, by replaying a CUDA graph of 20 captured
calls, at the serve shapes of granite-3-8b and zamba2-2.7b, at head dim 192
and at a long causal sequence.  A variant's output is wrong by design: only
its time means something.  The gap between ``base`` and a variant is what
that part costs where it does not overlap with the rest.

Variants: ``no_softmax`` (no mask, max, exponent or row sum: P is the raw
score), ``exp2f`` (the library's exp2f in place of ex2.approx), ``no_qk`` /
``no_pv`` / ``no_gemm`` (no Q.K^T, no P.V, neither wgmma), ``no_store`` (no
TMA store of O), ``no_pingpong`` (the two warpgroups issue their products
without taking turns), ``data_only`` (neither wgmma nor softmax: the TMA
loads and stores and the pipeline's waits alone) and ``loads_only`` (that
without the store).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "src/repro_torch/kernels/attention/csrc/flash_fwd_sm90.cu"
OUT_DIR = REPO / "build" / "flash_sm90_ablate"
SHAPES = [  # (B, S, H, K, hd, causal)
    (8, 512, 32, 8, 128, True),  # granite-3-8b's prompt forward
    (8, 512, 32, 32, 80, True),  # zamba2-2.7b's shared attention block
    (8, 512, 32, 8, 192, True),  # head dim 192 (nemotron-4-340b's)
    (1, 4096, 32, 8, 128, True),  # a long causal sequence
]


def variants(src: str) -> dict:
    def sub(text, old, new, regex=False):
        out = re.sub(old, new, text, flags=re.S) if regex else text.replace(old, new)
        if out == text:
            raise RuntimeError(f"substitution did not apply: {old[:60]!r}")
        return out

    softmax_call = r"softmax_tile<BK>\(sc, m_run, l_run, corr,[^;]*;"
    qk = "wgmma_ss<T::BK>(sc,"
    pv = "wgmma_rs<HD>(acc, &pa[4 * kk]"
    no_gemm = sub(sub(src, qk, "if (0) " + qk), pv, "if (0) " + pv)
    data_only = sub(no_gemm, softmax_call, "corr[0] = corr[1] = 1.f;", regex=True)
    store = "tma_store_4d(&tm_o,"
    return {
        "base": src,
        "no_softmax": sub(src, softmax_call, "corr[0] = corr[1] = 1.f;", regex=True),
        "exp2f": sub(src, "asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));",
                     "y = exp2f(x);"),
        "no_qk": sub(src, qk, "if (0) " + qk),
        "no_pv": sub(src, pv, "if (0) " + pv),
        "no_gemm": no_gemm,
        "no_store": sub(src, store, "if (0) " + store),
        "no_pingpong": sub(src, "mbar_wait(my_turn, turns++ & 1);", ""),
        "data_only": data_only,
        "loads_only": sub(data_only, store, "if (0) " + store),
    }


def build(srcs: dict) -> dict:
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        so = OUT_DIR / f"lib{name}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-4000:]}")
        spills = sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores", log)})
        print(f"variant {name}: spill stores {spills} bytes, "
              f"{log.count('Performance Loss')} ptxas performance warnings", flush=True)
        fn = ctypes.CDLL(str(so)).flash_fwd_sm90
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_sm90_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import graph_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    header = '#include "flash_sm90.cuh"'
    fns = build(variants(SOURCE.read_text().replace(header, (SOURCE.parent / "flash_sm90.cuh").read_text())))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for B, S, H, K, hd, causal in SHAPES:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda").bfloat16()
                   for n in (H, K, K))
        o = torch.empty_like(q)
        flops = 4 * B * H * hd * (S * (S + 1) // 2 if causal else S * S)
        row = {"shape": [B, S, H, K, hd, causal], "ms": {}}
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, K, hd,
                         int(causal), -1, 1 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name}: launch failed ({err})")
            row["ms"][name] = graph_ms(call)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row["ms"]["sdpa"] = graph_ms(lambda: sdpa(qh, kh, vh, is_causal=causal, enable_gqa=True))
        print(f"{tuple(row['shape'])}: " + ", ".join(
            f"{n} {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s)" for n, ms in row["ms"].items()),
            flush=True)
        results.append(row)
    if args.out:
        args.out.write_text(json.dumps({"device": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
