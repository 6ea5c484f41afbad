"""End-to-end training driver (counterpart of ``repro.launch.train``).

Trains on one device: the deterministic data pipeline, the microbatched
AdamW train step, async checkpoints with restart, failure injection with
restore, straggler tracking and optional gradient-compression state.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --full \\
      --batch 8 --seq 512 --steps 4 --microbatches 2

``--plan-chips N --plan-pod mira`` prints the fleet planner's ranked plan
for the arch at N midplanes of the machine (``--plan-shape``, default
``train_4k``) and returns the plan without building a model.

Differences from the JAX driver: ``--device`` picks the card (the default)
or the CPU; ``--plan-chips`` needs ``--plan-pod`` (one of the paper's Blue
Gene/Q machines, planned in torus mode at 2 GB/s a link: the port has no
default pod); the step timer stops after ``torch.cuda.synchronize()``;
parameters are made outside ``inference_mode``, since they are trained.
``main`` returns the mean losses of the first and last fifth of the steps,
as JAX's does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.planner import add_plan_arguments, plan_from_args
from repro_torch.models import build_model
from repro_torch.obs import timer as obs_timer
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim import compression as comp
from repro_torch.runtime import HeartbeatMonitor, StragglerTracker
from repro_torch.train import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--compress", choices=["none", "int8", "topk"], default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    add_plan_arguments(ap, default_shape="train_4k")
    return ap


def _to_device(batch, device: torch.device):
    """A pipeline batch (numpy) as tensors on ``device``; token ids as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.plan_chips is not None:
        return plan_from_args(ap, args)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    device = resolve_device(args.device)
    model = build_model(arch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps, weight_decay=0.01)
    params = model.init(args.seed, device)
    opt_state = adamw.init(params)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"arch={arch.name} params={n_params/1e6:.2f}M device={device}")

    step_fn = make_train_step(model, opt_cfg, args.microbatches)

    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        start_step, (params, opt_state) = mgr.restore((params, opt_state))
        print(f"resumed from checkpoint step {start_step}")

    # initialised only: as in the JAX driver, nothing crosses a slow link on one device
    comp_state = comp.init_state(params) if args.compress != "none" else None

    data_cfg = DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    pipeline = DataPipeline(arch, data_cfg, start_step=start_step)
    monitor = HeartbeatMonitor(["w0"], timeout=60.0)  # one device, one worker
    straggler = StragglerTracker()

    losses = []
    pending_save = None
    try:
        for step, batch in pipeline:
            if step >= args.steps:
                break
            if args.simulate_failure_at is not None and step == args.simulate_failure_at:
                print(f"[fault] simulated worker failure at step {step}; restoring")
                monitor.last_seen["w0"] = -np.inf
                failed = monitor.check()
                if failed != ["w0"]:
                    raise RuntimeError(f"the monitor declared {failed} failed, not ['w0']")
                if pending_save is not None:
                    pending_save.result()
                if mgr and mgr.latest_step() is not None:
                    restored_step, (params, opt_state) = mgr.restore((params, opt_state))
                    print(f"[fault] restored checkpoint step {restored_step}")
                monitor.rejoin("w0")
                args.simulate_failure_at = None  # don't loop
            with obs_timer("train.step", step=step) as tm:
                params, opt_state, metrics = step_fn(params, opt_state, _to_device(batch, device))
                synchronize(device)
                loss = float(metrics["loss"])
            dt = tm.elapsed
            straggler.record("w0", dt)
            losses.append(loss)
            if step % args.log_every == 0:
                print(
                    f"step {step:5d} loss {loss:.6f} "
                    f"gnorm {float(metrics['grad_norm']):.6f} "
                    f"lr {float(metrics['lr']):.3e} {dt*1e3:.3f} ms"
                )
            if mgr and (step + 1) % args.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.result()
                pending_save = mgr.save_async(step + 1, (params, opt_state))
    finally:
        pipeline.close()
        if pending_save is not None:
            pending_save.result()

    if mgr:
        mgr.save(args.steps, (params, opt_state))
        mgr.close()
    window = max(len(losses) // 5, 1)
    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    print(f"done: loss {first:.4f} -> {last:.4f} over {len(losses)} steps")
    return first, last


if __name__ == "__main__":
    main()
