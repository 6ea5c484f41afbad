#!/usr/bin/env python3
"""Where the MoE serve check's two paths route tokens differently, in bf16,
on one CUDA card.

    python3 tools/moe_routing_probe.py [--layers 16]

For mixtral-8x7b and phi3.5-moe-42b-a6.6b at full width with ``--layers`` of
their 32 layers in bf16 (the depth ``chip_smoke.py`` phase 4 profiles), runs
the serve launcher's prefill/decode check without its gate on 8 x 512-token
prompts: the prompt forward through the kernels at the no-drop capacity
against the teacher-forced decode.  Prints, per layer, the (token, request)
pairs whose top-k experts differ between the two paths (at every prompt
position and at the last), the probability gaps at the flips, and the
last-logit difference beside the check's tolerance.  This is the
measurement that keeps ``chip_smoke.py`` phase 3's MoE serving in float32.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def probe(torch, cfg) -> None:
    from chip_smoke import RoutingRecorder, depth_label
    from repro_torch.launch import serve
    from repro_torch.models import build_model, moe
    from repro_torch.train import make_prefill_step

    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = model.init(1, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    with RoutingRecorder(moe, cfg.n_layers, 512) as recorder, torch.inference_mode():
        last = make_prefill_step(build_model(serve.no_drop_config(cfg), impl="kernel"))(
            params, {"tokens": prompts})
        cache = model.init_cache(8, 512, device="cuda")
        logits, cache = serve.prefill_by_decode(model, params, cache, prompts)
    diff = float((last.float() - logits[:, -1].float()).abs().max())
    tol = serve.prefill_decode_tolerance(cfg.activation_dtype, logits[:, -1])
    print(f"{depth_label(cfg)} routing, no-drop prompt forward against teacher-forced decode "
          f"(not gated): {recorder.flips()}; last-logit max |diff| {diff:.4g} against the "
          f"check's tolerance {tol:.4g}", flush=True)
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
