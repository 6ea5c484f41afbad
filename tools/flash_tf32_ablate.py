#!/usr/bin/env python3
"""Where the float32 (split-TF32) flash kernel's time goes, on one CUDA card.

    python3 tools/flash_tf32_ablate.py [--out results.json]

Builds variants of ``src/repro_torch/kernels/attention/csrc/flash_fwd_tf32_sm90.cu``
with one part taken out or changed, each by a text substitution on a copy
of the source (every substitution must apply as many times as stated),
compiles them with ``nvcc`` in parallel into ``build/flash_tf32_ablate/``
and times each by replaying a CUDA graph of 20 captured calls, beside
PyTorch's ``scaled_dot_product_attention`` in float32, at the MoE serve
shape (mixtral-8x7b's (8, 512, 32, 8, 128), window 4096) and at
granite-3-8b's prompt-forward shape, both in float32.  Beside each time it
prints the variant's max |err| against the plain version run in float64 on
the same inputs, its mean signed error toward larger |want| over the mean
|want| (a bias: the float32 plain version's is near 0), and the share of
elements outside 2e-4 + 2e-4 |want|: a
variant that leaves work out is wrong by design, but ``one_product``
answers whether one TF32 product holds the tolerance at this shape.

With ``--serve`` it times nothing: it runs the float32 MoE serve check of
``chip_smoke.py`` phase 3 (mixtral-8x7b and phi3.5-moe-42b-a6.6b, 8 of 32
layers, serve_config's seed and prompts) once for each of ``SERVE_VARIANTS``
in the prompt forward's place of the kernel, against one teacher-forced
decode, through ``serve.prompt_forward`` and ``serve.check_prefill_decode``,
and prints each one's routing flips and their router-probability gaps
beside the check's verdict: the readings that ``serve.ROUTING_TIE_GAP``
and ``ROUTING_MAX_TIES`` sit between.

Variants: ``base``; ``one_product`` (one TF32 product, hi.hi: the hi.lo
and lo.hi wgmma calls of both products deleted); ``no_qk`` / ``no_pv`` (no
Q.K^T, no P.V wgmma); ``no_transpose_pass`` (V^T is not written: the V
tile's transposing split is skipped); ``no_split_k`` (K is not split: its
lo half keeps what it held); ``no_softmax`` (no mask, max, exponent or row
sum: P is the raw score); ``data_only`` (neither wgmma nor softmax: the TMA
loads, the splitting passes and the pipeline's waits alone);
``no_pv_lo_hi`` (P.V without its lo.hi product, which the CPU mirror shows
missing 2e-4); ``shrink_1e-5`` (every output times 1 - 1e-5: a bias toward
zero ten times the kernel's own, inside the elementwise tolerance).
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
SOURCE = REPO / "src/repro_torch/kernels/attention/csrc/flash_fwd_tf32_sm90.cu"
OUT_DIR = REPO / "build" / "flash_tf32_ablate"
SHAPES = [  # (B, S, H, K, hd, window)
    (8, 512, 32, 8, 128, 4096),  # mixtral-8x7b's (and phi3.5-moe's) prompt forward, float32
    (8, 512, 32, 8, 128, None),  # granite-3-8b's prompt forward
]
TOL = 2e-4
SERVE_VARIANTS = ("base", "shrink_1e-5", "no_pv_lo_hi", "one_product", "no_split_k")


def variants(src: str) -> dict:
    def sub(text, old, new, count=1, regex=False):
        n = len(re.findall(old, text, flags=re.M)) if regex else text.count(old)
        if n != count:
            raise RuntimeError(f"substitution applies {n} times, not {count}: {old[:60]!r}")
        return re.sub(old, new, text, flags=re.M) if regex else text.replace(old, new)

    qk = [" wgmma_rs_n32(sc, &qhi[4 * k], dkh);", " wgmma_ss_n32(sc, desc_at(q_wg",
          " wgmma_rs_n32(sc, &qhi[4 * k], desc_at(klo"]
    pv = [" wgmma_rs<NPV>(pv, &pa[4 * kk], dvh, kk > 0);", " wgmma_rs<NPV>(pv, &pa[4 * kk], desc_at(vlo",
          " wgmma_rs<NPV>(pv, &pl[4 * kk], dvh);"]

    def drop(text, calls):
        for call in calls:
            text = sub(text, call, " if (0)" + call)
        return text

    softmax = r"if \(mask\)\n\s*softmax_tile<true>[^;]*;\n\s*else\n\s*softmax_tile<false>[^;]*;"
    no_softmax = lambda text: sub(text, softmax, "corr[0] = corr[1] = 1.f;", regex=True)
    return {
        "base": src,
        "one_product": drop(src, [qk[1], qk[2], pv[1], pv[2]]),
        "no_qk": drop(src, qk),
        "no_pv": drop(src, pv),
        "no_transpose_pass": sub(src, "transpose_v<HD>(gbase", "if (0) transpose_v<HD>(gbase"),
        "no_split_k": sub(src, "split_k<HD>(kh,", "if (0) split_k<HD>(kh,"),
        "no_softmax": no_softmax(src),
        "data_only": no_softmax(drop(src, qk + pv)),
        "no_pv_lo_hi": drop(src, pv[2:]),
        "shrink_1e-5": sub(src, "inv[rr] = 1.f / fmaxf(l, 1e-30f);",
                           "inv[rr] = (1.f - 1e-5f) / fmaxf(l, 1e-30f);"),
    }


def build(srcs: dict) -> dict:
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
        lib = ctypes.CDLL(str(so))
        lib.flash_fwd_tf32_sm90.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_fwd_tf32_sm90.restype = ctypes.c_int
        lib.flash_fwd_tf32_sm90_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_tf32_sm90_error_string.restype = ctypes.c_char_p
        fns[name] = lib
    return fns


def serve_readings(torch, libs: dict) -> list:
    """``--serve``: the float32 MoE serve check with each variant in the
    prompt forward; returns one row per (arch, variant)."""
    import numpy as np

    import chip_smoke
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    kernel, rows = ops._kernel, []
    for arch in chip_smoke.MOE_SERVE_ARCHS:
        args = serve.build_parser().parse_args(chip_smoke.serve_args(arch))
        cfg = chip_smoke.moe_config(arch, chip_smoke.MOE_SERVE)
        device = torch.device(args.device)
        torch.cuda.empty_cache()
        model = build_model(cfg)  # serve_config's model, parameters, prompts and cache
        params = model.init(args.seed, device)
        prompts = np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int32)
        prompts = torch.from_numpy(prompts).long().to(device)
        routing = serve.DecodeRouting()
        with torch.inference_mode():
            cache = model.init_cache(args.requests, args.prompt_len + args.gen_len, device)
            with routing.recording():
                logits, _ = serve.prefill_by_decode(model, params, cache, prompts)
            del cache
            for name, lib in libs.items():
                ops._kernel = lambda stem, lib=lib: lib if stem == "flash_fwd_tf32_sm90" else kernel(stem)
                before = ops.tf32_launches
                try:
                    last = serve.prompt_forward(cfg, params, prompts, routing)
                finally:
                    ops._kernel = kernel
                check = serve.check_prefill_decode(cfg, last, logits[:, -1], routing)
                rows.append({"arch": arch, "variant": name, "launches": ops.tf32_launches - before,
                             **check})
                print(f"{arch}, {name}: {rows[-1]['launches']} float32 flash launches; last-logit "
                      f"max |diff| {check['max_abs_diff']:.4g} (tol {check['tol']:g}); routing "
                      f"{check['routing']}; verdict: {check['fault'] or 'passes'}", flush=True)
        del params, logits
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    ap.add_argument("--serve", action="store_true",
                    help="run the float32 MoE serve check with SERVE_VARIANTS, time nothing")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_tf32_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    from chip_smoke import graph_ms
    from repro_torch.kernels.attention import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    srcs = variants(SOURCE.read_text())
    if args.serve:
        rows = serve_readings(torch, build({n: srcs[n] for n in SERVE_VARIANTS}))
        if args.out:
            args.out.write_text(json.dumps({"device": smi, "serve": rows}, indent=1))
        return 0
    fns = {name: lib.flash_fwd_tf32_sm90 for name, lib in build(srcs).items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for B, S, H, K, hd, window in SHAPES:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda") for n in (H, K, K))
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        want = ref.attention_reference(qh.double(), kh.double(), vh.double(),
                                       window=window).transpose(1, 2)
        o = torch.empty_like(q)
        flops = 4 * B * H * hd * (S * (S + 1) // 2)
        row = {"shape": [B, S, H, K, hd, window], "ms": {}, "max_abs_err": {}, "bias": {},
               "share_out": {}}
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, K, hd,
                         1, -1 if window is None else window, 1 / math.sqrt(hd),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name}: launch failed ({err})")
            o.zero_()
            call()
            torch.cuda.synchronize()
            e = (o.double() - want).abs()
            row["max_abs_err"][name] = float(e.nan_to_num(float("inf")).max())
            row["bias"][name] = float(((o.double() - want) * want.sign()).mean() / want.abs().mean())
            row["share_out"][name] = float((~(e <= TOL + TOL * want.abs())).double().mean())
            row["ms"][name] = graph_ms(call)
        row["ms"]["sdpa"] = graph_ms(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True))
        print(f"{tuple(row['shape'])}:", flush=True)
        for name, ms in row["ms"].items():
            err = ("" if name == "sdpa" else f", max |err| {row['max_abs_err'][name]:.3g}, "
                   f"bias {row['bias'][name]:.3g}, share out of tolerance "
                   f"{row['share_out'][name]:.4f}")
            print(f"  {name}: {ms:.4f} ms ({3 * flops / ms / 1e9:.0f} TFLOP/s of split-TF32 "
                  f"products){err}", flush=True)
        results.append(row)
        del q, k, v, qh, kh, vh, want, o
    if args.out:
        args.out.write_text(json.dumps({"device": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
