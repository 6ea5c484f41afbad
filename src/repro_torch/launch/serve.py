"""Batched serving driver (counterpart of ``repro.launch.serve``): prefill,
then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --no-reduced --requests 8 --prompt-len 512 --gen-len 32

The prompts first go through ``make_prefill_step`` on a model built with the
hand-written kernels: flash attention (one launch per attention block) and
the SSD / RWKV6 scans (one launch per Mamba2 or RWKV6 layer).  The cache
(KV, SSM or WKV state) is then filled by
teacher-forced ``decode_step``, exactly as the JAX driver does, and the
prefill's last-position logits must agree with the decode's last logits
(the decode == prefill invariant of the JAX tests).  Greedy decode follows.

For a mixture-of-experts config the check's prompt forward runs at the
capacity factor E / k (C >= S: no token can be dropped), because decode
never drops: one token per group gives C = 4 >= k.  At the configured
factor (1.25) a 512-token prompt forward would drop tokens, and it would
no longer be the function decode computes.  The served tokens come from
decode alone, so this changes none of them.  The JAX invariant test does
the same with a factor of 8 (tests/test_arch_smoke.py).

Differences from the JAX driver: ``--reduced`` can be turned off
(``--no-reduced`` runs full width; the JAX flag is ``store_true`` with
``default=True``), ``--device`` picks the card or the CPU, ``--plan-chips``
is absent until the planner is ported, and ``main`` returns a dict of
results rather than the throughput alone.  ``serve_config`` serves a
given config (a depth-cut one, say) with the same steps.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import Model, build_model
from repro_torch.models.moe import expert_capacity
from repro_torch.obs import timer as obs_timer
from repro_torch.train import make_prefill_step

# Largest |prefill - decode| allowed on the last-position logits, by
# activation dtype.  float32 is the JAX test's bound (test_arch_smoke.py).
# bfloat16 keeps 8 significant bits, and the two paths round at different
# points (the flash kernel scores in float32, decode attention in bf16), so
# the drift grows with depth: the bound is relative to the largest logit.
PREFILL_DECODE_TOL = {"float32": 3e-4, "bfloat16": 5e-2}


def prefill_decode_tolerance(dtype: str, logits: torch.Tensor) -> float:
    tol = PREFILL_DECODE_TOL[dtype]
    if dtype == "bfloat16":
        tol *= max(1.0, float(logits.float().abs().max()))
    return tol


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def no_drop_config(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with an MoE capacity factor of E / k, where every expert can
    take every token of a group (C >= S): the prompt forward then drops
    nothing, as decode drops nothing.  Other configs are returned as they
    are."""
    if cfg.moe is None:
        return cfg
    factor = cfg.moe.num_experts / cfg.moe.top_k
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def prefill_by_decode(
    model: Model, params, cache, prompts: torch.Tensor
) -> Tuple[torch.Tensor, Any]:
    """Fill the cache by teacher-forced decode over the prompt (exact cache
    population); returns the last step's logits and the cache."""
    logits = None
    for t in range(prompts.shape[1]):
        logits, cache = model.decode_step(params, cache, {"tokens": prompts[:, t : t + 1]}, t)
    return logits, cache


def greedy_decode(
    model: Model, params, cache, logits: torch.Tensor, start: int, gen_len: int
) -> torch.Tensor:
    """``gen_len`` greedy tokens after the prompt, from the prompt's last
    logits; ids above the vocabulary (padding rows) are never chosen."""
    vocab = model.cfg.vocab_size
    out_tokens = []
    tok = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]
    for i in range(gen_len):
        out_tokens.append(tok)
        logits, cache = model.decode_step(params, cache, {"tokens": tok}, start + i)
        tok = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]
    return torch.cat(out_tokens, dim=1)


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    return serve_config(arch, args, resolve_device(args.device))


@torch.inference_mode()
def serve_config(arch: ArchConfig, args: argparse.Namespace, device: torch.device) -> Dict[str, Any]:
    """Serve ``arch`` with ``args``' requests, lengths and seed on
    ``device``; returns ``main``'s dict."""
    if arch.frontend != "none":
        raise SystemExit("the server supports token LMs (use token archs)")
    model = build_model(arch)
    params = model.init(args.seed, device)
    B = args.requests
    cache = model.init_cache(B, args.prompt_len + args.gen_len, device)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, arch.vocab_size, (B, args.prompt_len), dtype=np.int32)
    prompts = torch.from_numpy(prompts).long().to(device)

    # prompt forward through the kernels (an MoE at its no-drop capacity)
    check_arch = no_drop_config(arch)
    prefill = make_prefill_step(build_model(check_arch, impl="kernel"))
    with obs_timer("serve.prefill_kernels", requests=B, tokens=args.prompt_len) as tm:
        prefill_logits = prefill(params, {"tokens": prompts})
        synchronize(device)
    t_prompt = tm.elapsed

    with obs_timer("serve.prefill", requests=B, tokens=args.prompt_len) as tm:
        logits, cache = prefill_by_decode(model, params, cache, prompts)
        synchronize(device)
    t_prefill = tm.elapsed

    diff = float((prefill_logits.float() - logits[:, -1].float()).abs().max())
    tol = prefill_decode_tolerance(arch.activation_dtype, logits[:, -1])
    if not diff <= tol:
        raise RuntimeError(
            f"prefill/decode logits disagree: max |diff| {diff:.6g} > tolerance {tol:.6g}"
        )

    with obs_timer("serve.decode", requests=B, tokens=args.gen_len) as tm:
        gen = greedy_decode(model, params, cache, logits, args.prompt_len, args.gen_len)
        synchronize(device)
    t_decode = tm.elapsed

    gen = gen.cpu().numpy()
    tps = B * args.gen_len / t_decode
    print(f"arch={arch.name} device={device} requests={B} prompt={args.prompt_len} gen={args.gen_len}")
    print(f"prompt forward (kernels) {t_prompt*1e3:.1f} ms; teacher-forced prefill {t_prefill*1e3:.1f} ms; "
          f"decode {t_decode*1e3:.1f} ms ({tps:.1f} tok/s aggregate)")
    print(f"prefill/decode last-logit max |diff| {diff:.6g} (tolerance {tol:.6g})")
    if arch.moe is not None:
        print(f"MoE: the check's prompt forward ran at capacity factor "
              f"{check_arch.moe.capacity_factor:g} (no drops; configured "
              f"{arch.moe.capacity_factor:g}); decode capacity "
              f"{expert_capacity(arch, 1)} >= top-k {arch.moe.top_k} drops nothing")
    print("sample generations (token ids):")
    for b in range(min(B, 3)):
        print(f"  req{b}: {gen[b, :12].tolist()}...")
    if gen.shape != (B, args.gen_len) or int(gen.max()) >= arch.vocab_size:
        raise RuntimeError(f"bad generations: shape {gen.shape}, max id {int(gen.max())}")
    return {
        "tokens": gen,
        "tokens_per_s": tps,
        "prompt_forward_s": t_prompt,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "prefill_decode_max_abs_diff": diff,
        "prefill_decode_tol": tol,
    }


if __name__ == "__main__":
    main()
