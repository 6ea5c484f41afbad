#!/usr/bin/env python3
"""Where the MoE serve check's two paths route tokens differently, in bf16,
on one CUDA card.

    python3 tools/moe_routing_probe.py [--layers 16]

For mixtral-8x7b and phi3.5-moe-42b-a6.6b at full width with ``--layers`` of
their 32 layers in bf16 (16 by default; ``chip_smoke.py`` phase 4 profiles 8), runs
the serve launcher's prefill/decode check without its gate on 8 x 512-token
prompts: the teacher-forced decode, then the prompt forward through the
kernels at the no-drop capacity (``serve.prompt_forward``; in bf16 it keeps
its own experts).  Prints ``serve.DecodeRouting``'s summary: per layer, the
(token, request) pairs whose top-k experts differ between the two paths (at
every prompt position and at the last), the router-probability gaps at the
flips, and the last-logit difference beside the check's tolerance.  This is the
measurement that keeps ``chip_smoke.py`` phase 3's MoE serving in float32.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def probe(torch, cfg) -> None:
    from chip_smoke import depth_label
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = model.init(1, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    routing = serve.DecodeRouting()
    with torch.inference_mode():
        cache = model.init_cache(8, 512, device="cuda")
        with routing.recording():
            logits, cache = serve.prefill_by_decode(model, params, cache, prompts)
        last = serve.prompt_forward(cfg, params, prompts, routing)
        check = serve.check_prefill_decode(cfg, last, logits[:, -1], routing)
    print(f"{depth_label(cfg)} routing, no-drop prompt forward against teacher-forced decode "
          f"(not gated): {check['routing']}; last-logit max |diff| {check['max_abs_diff']:.4g} "
          f"against the check's tolerance {check['tol']:.4g}", flush=True)
    del params, cache


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layers", type=int, default=16)
    layers = parser.parse_args().layers
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("moe_routing_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    for arch in chip_smoke.MOE_SERVE_ARCHS:
        probe(torch, chip_smoke.moe_config(arch, (layers, "bfloat16")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
