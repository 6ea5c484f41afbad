#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card's name and power limit (nvidia-smi), build every CUDA
   kernel of the port from the sources in this checkout, print the build time.
2. Hold each kernel against its plain PyTorch version on the card: the flash
   attention sweep of the JAX package's kernel tests (MHA, GQA 2:1 and 4:1,
   MQA; windows 32/96/1024; blocks 128/32; float32 at 2e-4 and bfloat16 at
   2e-2), then granite-3-8b's prefill shape, where the kernel, the plain
   version and PyTorch's fused attention are timed with CUDA events.
3. Serve granite-3-8b at full width and depth with random weights (seeded
   on the card): 8 requests, 512-token prompts, 32 generated tokens.  The
   flash kernel must launch once per layer in that run, the prefill and the
   teacher-forced decode must agree, and every generated id must lie below
   the vocabulary size.
4. Profile the serving loop (teacher-forced prefill and greedy decode) at
   full width with torch.profiler: wall and device-busy time per decode
   step, the device's idle share and the kernels that take the most time.

The line before the last is a JSON object with each kernel's launches on the
main path, error, times and bound; the last line names the device.  With no
CUDA card, or run outside a checkout of the repository, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, no sparsity) for the bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

FLASH_SWEEP = [  # (B, S, H, K, hd, blk_q, blk_k, window), tests/test_kernels.py
    (1, 128, 4, 4, 32, 64, 64, None),  # MHA
    (2, 256, 4, 2, 64, 64, 64, None),  # GQA 2:1
    (1, 256, 8, 2, 16, 128, 128, None),  # GQA 4:1, small head dim
    (1, 64, 2, 1, 128, 32, 32, None),  # MQA
]
FLASH_WINDOWS = [(1, 256, 4, 2, 32, 64, 64, w) for w in (32, 96, 1024)]
FLASH_ASYMMETRIC = [(1, 256, 2, 2, 32, 128, 32, None)]
GRANITE_ATTN = (8, 512, 32, 8, 128, 128, 128, None)  # prefill of the serve phase

SERVE_ARGS = [
    "--arch", "granite-3-8b", "--no-reduced", "--requests", "8",
    "--prompt-len", "512", "--gen-len", "32", "--seed", "0", "--device", "cuda",
]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_inputs(case, dtype, gen):
    import torch

    B, S, H, K, hd = case[:5]
    mk = lambda heads: torch.randn(B, S, heads, hd, generator=gen, device="cuda").to(dtype)
    return mk(H), mk(K), mk(K)


def check_flash(case, dtype, gen, tol):
    """Kernel vs plain version on one case; returns (max |err|, inputs)."""
    import torch
    from repro_torch.kernels.attention import ops, ref

    _, _, _, _, _, blk_q, blk_k, window = case
    q, k, v = flash_inputs(case, dtype, gen)
    out = ops.flash_attention(q, k, v, causal=True, window=window, blk_q=blk_q, blk_k=blk_k)
    torch.cuda.synchronize()
    want = ref.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True, window=window
    ).transpose(1, 2)
    err = (out.float() - want.float()).abs()
    max_err = float(err.max())
    bad = int((err > tol + tol * want.float().abs()).sum())
    print(f"  flash {case[:5]} blk {blk_q}/{blk_k} window {window} {str(dtype)[6:]}: "
          f"max |err| {max_err:.3g} (tol {tol:g})")
    if bad or not torch.isfinite(out.float()).all():
        raise RuntimeError(f"flash kernel disagrees with the plain version on {case} {dtype}: "
                           f"{bad} elements out of tolerance, max |err| {max_err}")
    return max_err, (q, k, v)


def flash_bound_ms(case, dtype_bytes: int):
    """Least time for the function at a causal case: bytes of q, k, v, o
    once over HBM rate vs 4*hd flops per unmasked (q, k) pair over the bf16
    peak.  Returns (ms, "bytes" | "operations")."""
    B, S, H, K, hd = case[:5]
    nbytes = dtype_bytes * B * S * hd * (2 * H + 2 * K)
    pairs = S * (S + 1) // 2
    flops = 4 * hd * B * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_serving_loop(cfg, n_prompt: int = 64, n_gen: int = 8, batch: int = 8) -> dict:
    """Device busy share of the serving loop (teacher-forced prefill, then
    greedy decode) at full width.  The loop runs untraced twice (the first
    run absorbs lazy set-up, the second gives the wall time), then once under
    torch.profiler, whose kernel intervals give the device's busy time; the
    tracer slows the host, so the idle share divides by the untraced wall.
    Kernels run on one stream, so their intervals do not overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, n_prompt), device="cuda", generator=gen)

    def loop():
        cache = model.init_cache(batch, n_prompt + n_gen, device="cuda")
        logits, cache = serve.prefill_by_decode(model, params, cache, prompts)
        serve.greedy_decode(model, params, cache, logits, n_prompt, n_gen)
        torch.cuda.synchronize()

    with torch.inference_mode():
        loop()
        t0 = time.perf_counter()
        loop()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop()
            traced_wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    steps = n_prompt + n_gen
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "traced_wall_ms_per_step": traced_wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "top_kernels_ms_per_step": [(name[:60], us / steps / 1e3) for name, us in top],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops, ref
    from repro_torch.launch import serve

    # -- phase 1: card and build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    build_s = _build.build_all(verbose=True)
    print(f"phase 1: built {len(_build.sources())} kernel source(s) in {build_s:.1f} s", flush=True)

    # -- phase 2: kernels vs plain versions ------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("phase 2: flash attention kernel vs plain version")
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        for case in FLASH_SWEEP:
            check_flash(case, dtype, gen, tol)
    for case in FLASH_WINDOWS + FLASH_ASYMMETRIC:
        check_flash(case, torch.float32, gen, 2e-4)
    err, (q, k, v) = check_flash(GRANITE_ATTN, torch.bfloat16, gen, 2e-2)
    kernel_ms = cuda_ms(lambda: ops.flash_attention(q, k, v))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    plain_ms = cuda_ms(lambda: ref.attention_reference(qh, kh, vh, causal=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True))
    bound_ms, bound_by = flash_bound_ms(GRANITE_ATTN, q.element_size())
    print(f"  granite shape {GRANITE_ATTN[:5]} bf16: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)

    # -- phase 3: full-width serving ---------------------------------------------
    cfg = get_arch("granite-3-8b")
    print(f"phase 3: serve {cfg.name} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, {cfg.param_count() / 1e9:.2f} B parameters", flush=True)
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    result = serve.main(SERVE_ARGS)
    launches = ops.launches
    if launches != cfg.n_layers:
        raise RuntimeError(f"flash kernel launched {launches} times in the serve run, "
                           f"expected {cfg.n_layers} (one per layer)")
    gen_ids = result["tokens"]
    if gen_ids.shape != (8, 32) or int(gen_ids.max()) >= cfg.vocab_size or int(gen_ids.min()) < 0:
        raise RuntimeError(f"generated ids out of range: shape {gen_ids.shape}")
    print(f"  flash launches {launches}; prefill (flash) {result['flash_prefill_s'] * 1e3:.1f} ms; "
          f"teacher-forced prefill {result['prefill_s'] * 1e3:.1f} ms; decode "
          f"{result['decode_s'] * 1e3:.1f} ms; {result['tokens_per_s']:.1f} tok/s; "
          f"prefill/decode max |diff| {result['prefill_decode_max_abs_diff']:.4g} "
          f"(tol {result['prefill_decode_tol']:.4g}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # -- phase 4: where the serving loop's time goes ----------------------------
    prof = profile_serving_loop(cfg)
    print(f"phase 4: serving loop at full width, {prof['steps']} decode steps of 8 requests: "
          f"{prof['wall_ms_per_step']:.3f} ms/step wall ({prof['traced_wall_ms_per_step']:.3f} "
          f"traced), {prof['device_busy_ms_per_step']:.3f} ms/step device busy, device idle "
          f"share {prof['device_idle_share']:.3f}")
    for name, ms in prof["top_kernels_ms_per_step"]:
        print(f"  {ms:8.4f} ms/step  {name}")

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/attention/flash.py:33",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
