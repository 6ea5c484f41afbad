"""Batched serving driver (counterpart of ``repro.launch.serve``): prefill,
then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --no-reduced --requests 8 --prompt-len 512 --gen-len 32

The cache (KV, SSM or WKV state) is first filled by teacher-forced
``decode_step`` over the prompts, exactly as the JAX driver does.  The
prompts then go through ``make_prefill_step`` on a model built with the
hand-written kernels: flash attention (one launch per attention block) and
the SSD / RWKV6 scans (one launch per Mamba2 or RWKV6 layer).  The prompt
forward's last-position logits must agree with the decode's last logits
(the decode == prefill invariant of the JAX tests).  Greedy decode follows.

For a mixture-of-experts config the check's prompt forward runs at the
capacity factor E / k (C >= S: no token can be dropped), because decode
never drops: one token per group gives C = 4 >= k.  At the configured
factor (1.25) a 512-token prompt forward would drop tokens, and it would
no longer be the function decode computes.  The served tokens come from
decode alone, so this changes none of them.  The JAX invariant test does
the same with a factor of 8 (tests/test_arch_smoke.py).  The check also compares
both paths' experts (``DecodeRouting``, through ``moe.routing``); in
float32 the prompt forward takes decode's experts at a near-tie that
rounding alone can decide, and a flip beyond one fails the check
(``ROUTING_TIE_GAP``).

``--plan-chips N --plan-pod mira`` prints the fleet planner's ranked plan
for the arch at N midplanes of the machine (``--plan-shape``, default
``decode_32k``) and returns the plan without building a model, as the
JAX server's ``--plan-chips`` does:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --plan-chips 16 --plan-pod mira

Differences from the JAX driver: ``--reduced`` can be turned off
(``--no-reduced`` runs full width; the JAX flag is ``store_true`` with
``default=True``), ``--device`` picks the card or the CPU, ``--plan-chips``
needs ``--plan-pod`` (one of the paper's Blue Gene/Q machines, planned in
torus mode at 2 GB/s a link: the port has no default pod), and ``main``
returns a dict of results rather than the throughput alone.  ``serve_config`` serves a
given config (a depth-cut one, say) with the same steps.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.planner import add_plan_arguments, plan_from_args
from repro_torch.models import Model, build_model
from repro_torch.models import moe
from repro_torch.models.moe import expert_capacity
from repro_torch.obs import timer as obs_timer
from repro_torch.train import make_prefill_step

# Largest |prefill - decode| allowed on the last-position logits, by
# activation dtype.  float32 is the JAX test's bound (test_arch_smoke.py).
# bfloat16 keeps 8 significant bits, and the two paths round at different
# points (the flash kernel scores in float32, decode attention in bf16), so
# the drift grows with depth: the bound is relative to the largest logit.
PREFILL_DECODE_TOL = {"float32": 3e-4, "bfloat16": 5e-2}


# The float32 MoE check's routing ties.  Where the prompt forward and the
# teacher-forced decode give a (token, layer) pair different experts, its
# gap is the forward's k-th largest router probability less the forward's
# probability of decode's least likely expert.  At a gap of at most
# ROUTING_TIE_GAP the pair is a tie that float32 rounding alone can decide,
# and the forward takes decode's experts there (one flipped tie moves that
# token's residual, which later layers and tokens read, far beyond the
# logit bound).  A flip beyond the gap, or more than ROUTING_MAX_TIES ties,
# fails the check.  Readings at mixtral-8x7b's and phi3.5-moe's full width
# (tools/flash_tf32_ablate.py --serve; PERF.md section 6): the sound float32
# flash kernel flips one pair each, at gaps of 2.4e-7 and 1.9e-7; a
# variant biased by 1e-5, inside the kernel's tolerance, two at most, the
# largest 1.8e-6; every faulty variant flips 49 or more beyond 1e-5, the
# largest at 0.09 to 0.31.  The tie count (1 to 2 when sound) has no faulty
# reading above it: it is there for a fault that moves many pairs by less
# than the gap.
ROUTING_TIE_GAP = 1e-5
ROUTING_MAX_TIES = 8


class DecodeRouting:
    """Both paths' routing in the serve check of an MoE config, through
    ``moe.routing``.  Under ``recording()`` it keeps each layer's top-k
    experts over the teacher-forced decode (one token a call).  Under
    ``forward(tie_gap)`` it compares the prompt forward's own top-k with
    decode's, layer by layer, and where ``tie_gap`` is given, takes decode's
    experts at the pairs that differ by a gap of at most ``tie_gap``.  The
    hooks keep their tallies on the device; ``summary()`` reads them."""

    def __init__(self):
        self.decode, self._forward, self.tie_gap = [], [], None

    def recording(self):
        return moe.routing(self._record)

    def forward(self, tie_gap=None):
        self._forward, self.tie_gap = [], tie_gap
        return moe.routing(self._compare)

    def _record(self, probs, w, ids):
        if probs.shape[1] == 1:
            self.decode.append(ids)
        return w, ids

    def _compare(self, probs, w, ids):
        S = probs.shape[1]
        n_layers = len(self.decode) // S
        dec = torch.cat(self.decode[len(self._forward)::n_layers], dim=1)  # (B, S, k), step-major calls
        differs = (ids.sort(-1).values != dec.sort(-1).values).any(-1)  # (B, S)
        p_dec, order = probs.gather(-1, dec).sort(dim=-1, descending=True, stable=True)
        gap = w[..., -1] - p_dec[..., -1]
        self._forward.append((differs, gap))
        if self.tie_gap is None:
            return w, ids
        tie = (differs & (gap <= self.tie_gap))[..., None]
        return torch.where(tie, p_dec, w), torch.where(tie, dec.gather(-1, order), ids)

    def summary(self) -> Dict[str, Any]:
        """The pairs routed differently (``flips``, per layer at every
        prompt position and at the last), the largest and least gap among
        them, and, where ties were taken, how many (``ties``), the largest
        tie's gap and the flips beyond ``tie_gap``."""
        differs = torch.stack([d for d, _ in self._forward])  # (L, B, S)
        gaps = torch.stack([g for _, g in self._forward])[differs].double().cpu()
        out = {
            "flips_by_layer": differs.sum(dim=(1, 2)).tolist(),
            "last_position_flips_by_layer": differs[:, :, -1].sum(dim=1).tolist(),
            "pairs_per_layer": differs[0].numel(),
            "max_gap": float(gaps.max()) if len(gaps) else None,
            "min_gap": float(gaps.min()) if len(gaps) else None,
        }
        if self.tie_gap is not None:
            tied = gaps <= self.tie_gap
            out.update(ties=int(tied.sum()), max_tie_gap=float(gaps[tied].max()) if tied.any() else 0.0,
                       beyond_tie=int((~tied).sum()))
        return out


def routing_fault(summary: Dict[str, Any]) -> Optional[str]:
    """Why a float32 MoE check's routing fails it, or None."""
    if summary["beyond_tie"]:
        return (f"{summary['beyond_tie']} (token, layer) pairs routed differently beyond a tie "
                f"(largest gap {summary['max_gap']:.3g} > {ROUTING_TIE_GAP:g})")
    if summary["ties"] > ROUTING_MAX_TIES:
        return f"{summary['ties']} routing ties, more than {ROUTING_MAX_TIES}"
    return None


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
    add_plan_arguments(ap, default_shape="decode_32k")
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


def prompt_forward(arch: ArchConfig, params, prompts: torch.Tensor, routing: DecodeRouting):
    """The serve check's prompt forward: last-position logits through the
    kernels at the no-drop capacity.  An MoE's routing is compared with
    decode's (``routing`` has recorded it); in float32 the forward takes
    decode's experts at ties."""
    prefill = make_prefill_step(build_model(no_drop_config(arch), impl="kernel"))
    if arch.moe is None:
        return prefill(params, {"tokens": prompts})
    with routing.forward(ROUTING_TIE_GAP if arch.activation_dtype == "float32" else None):
        return prefill(params, {"tokens": prompts})


def check_prefill_decode(arch: ArchConfig, prefill_logits: torch.Tensor, decode_last: torch.Tensor,
                         routing: DecodeRouting) -> Dict[str, Any]:
    """The prompt forward's last logits against the teacher-forced
    decode's, and for an MoE both paths' routing.  Returns the max |diff|,
    its tolerance, the routing summary and ``fault``: why the check fails,
    or None."""
    diff = float((prefill_logits.float() - decode_last.float()).abs().max())
    tol = prefill_decode_tolerance(arch.activation_dtype, decode_last)
    summary = routing.summary() if arch.moe else None
    fault = routing_fault(summary) if summary and routing.tie_gap is not None else None
    if fault is None and not diff <= tol:
        fault = f"logits disagree: max |diff| {diff:.6g} > tolerance {tol:.6g}"
    return {"max_abs_diff": diff, "tol": tol, "routing": summary, "fault": fault}


def main(argv=None):
    """Serve, and return ``serve_config``'s dict; with ``--plan-chips``,
    print and return the fleet planner's plan instead."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.plan_chips is not None:
        return plan_from_args(ap, args)
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

    # the cache filled by teacher-forced decode (an MoE's experts recorded),
    # then the prompt forward through the kernels against its last logits
    routing = DecodeRouting()
    with obs_timer("serve.prefill", requests=B, tokens=args.prompt_len) as tm:
        with routing.recording() if arch.moe else contextlib.nullcontext():
            logits, cache = prefill_by_decode(model, params, cache, prompts)
        synchronize(device)
    t_prefill = tm.elapsed

    with obs_timer("serve.prefill_kernels", requests=B, tokens=args.prompt_len) as tm:
        prefill_logits = prompt_forward(arch, params, prompts, routing)
        synchronize(device)
    t_prompt = tm.elapsed
    check = check_prefill_decode(arch, prefill_logits, logits[:, -1], routing)
    if check["fault"]:
        raise RuntimeError(f"prefill/decode check: {check['fault']}; routing {check['routing']}")
    diff, tol = check["max_abs_diff"], check["tol"]

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
              f"{no_drop_config(arch).moe.capacity_factor:g} (no drops; configured "
              f"{arch.moe.capacity_factor:g}); decode capacity "
              f"{expert_capacity(arch, 1)} >= top-k {arch.moe.top_k} drops nothing; "
              f"routing against decode's: {check['routing']}")
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
        "routing": check["routing"],
    }


if __name__ == "__main__":
    main()
