"""Train, eval and serve step builders (counterpart of
``repro.train.steps``).

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``:

* the batch is split along axis 0 into ``microbatches`` pieces, each
  piece's gradients taken with ``torch.autograd.grad`` and added into
  float32 accumulators, which are then divided by the count, as JAX's
  float32 scan carry does (``.grad`` would accumulate in bf16); with one
  microbatch the gradients stay in the parameter dtype, as JAX's do;
* the remat policy is the model's (each layer recomputed in the backward
  pass with ``remat="block"``);
* the AdamW update runs in float32 with global-norm clipping, in place
  (``repro_torch.optim.adamw``);
* ``grad_placements`` (a tree of DTensor placements like the parameters,
  JAX's ``grad_shardings``) redistributes each microbatch's DTensor
  gradients, and the accumulators, to those placements, so that partial
  gradients are reduce-scattered to the parameters' shards (the dry-run).

Each microbatch's forward pass is the ``train.forward`` span and its
backward pass, block remat's recompute included, ``train.backward``; the
float32 accumulation is ``train.accumulate`` and the AdamW update
``train.optimizer`` (``repro_torch.obs``).

The train step takes the model's ``"torch"`` paths, as the JAX trainer takes
``attn_impl="xla"``.  On the card their attention, for bf16 at a head dim
the backward kernels take, is the flash kernel with its statistics and
``csrc/flash_bwd_sm90.cu`` in the backward pass
(``layers.takes_flash_backward``); the SSD and WKV scan kernels have no
backward, so a model built with ``impl="kernel"`` is refused.  The eval
step is forward only and takes either.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import obs, tree
from repro_torch.models.model import Model
from repro_torch.optim import adamw

PyTree = Any


def _grads(model: Model, params: PyTree, batch: Dict[str, torch.Tensor]
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """(loss, metrics, gradient of every leaf in ``tree.leaves`` order), the
    gradients in the parameter dtype."""
    flat = tree.leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in flat]
        with obs.trace("train.forward"):
            loss, metrics = model.loss(tree.unflatten(params, live), batch)
        with obs.trace("train.backward"):
            grads = torch.autograd.grad(loss, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


def _rows(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Piece ``i`` of ``n`` of ``v`` along axis 0.  A DTensor is cut on each
    rank's shard, so the piece keeps the batch's placements and no rank
    sends rows to another (a slice of its global rows would gather them)."""
    if not hasattr(v, "placements"):
        k = v.shape[0] // n
        return v[i * k : (i + 1) * k]
    from torch.distributed.tensor import DTensor

    local = v.to_local()
    k = local.shape[0] // n
    shape = (v.shape[0] // n, *v.shape[1:])
    return DTensor.from_local(local[i * k : (i + 1) * k], v.device_mesh, v.placements, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def _microbatch(batch: Dict[str, torch.Tensor], n: int, i: int) -> Dict[str, torch.Tensor]:
    """Piece ``i`` of ``n`` of every batch leaf along axis 0 (of
    ``shape[0] // n`` rows, as JAX's ``dynamic_slice_in_dim``)."""
    return {k: _rows(v, n, i) for k, v in batch.items()}


def _constrain(grads: List[torch.Tensor], placements) -> List[torch.Tensor]:
    """Each DTensor gradient redistributed to its entry of ``placements``
    (a list in ``tree.leaves`` order, or None)."""
    if placements is None:
        return grads
    return [g.redistribute(g.device_mesh, pl) for g, pl in zip(grads, placements, strict=True)]


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """A float32 accumulator like ``p``: for a DTensor, one of its
    placements built from a zero local shard, so that no op takes ``p``
    itself (the dry-run gathers a parameter for every op that does)."""
    if hasattr(p, "placements"):
        from torch.distributed.tensor import DTensor

        local = torch.zeros(p.to_local().shape, dtype=torch.float32, device=p.device)
        return DTensor.from_local(local, p.device_mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_step(
    model: Model, opt_cfg: adamw.AdamWConfig, microbatches: int = 1,
    grad_placements: Optional[PyTree] = None,
) -> Callable:
    if model.impl != "torch":
        raise ValueError(
            f"make_train_step needs a model built with impl='torch', not {model.impl!r}: "
            "the scan kernels have no backward pass"
        )
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    placements = None
    if grad_placements is not None:
        placements = tree.leaves(grad_placements, is_leaf=lambda n: isinstance(n, tuple))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = _grads(model, params, batch)
            grads = _constrain(grads, placements)
        else:
            flat = tree.leaves(params)
            with obs.trace("train.accumulate"):
                acc = _constrain([_zeros_f32(p) for p in flat], placements)
                l_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for i in range(microbatches):
                loss, _, grads = _grads(model, params, _microbatch(batch, microbatches, i))
                grads = _constrain(grads, placements)
                with obs.trace("train.accumulate"):
                    for a, g in zip(acc, grads):
                        a.add_(g)
                    l_sum = l_sum + loss
                del grads
            with obs.trace("train.accumulate"):
                grads = [a.div_(microbatches) for a in acc]
                loss = l_sum / microbatches
            metrics = {}
        with obs.trace("train.optimizer"):
            new_params, new_opt, opt_metrics = adamw.update(
                opt_cfg, tree.unflatten(params, grads), opt_state, params
            )
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_eval_step(model: Model) -> Callable:
    """Loss and metrics, forward only (``inference_mode``); a model built
    with ``impl="kernel"`` runs the hand-written kernels here."""

    @torch.inference_mode()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def make_prefill_step(model: Model) -> Callable:
    """Prefill: forward over the prompt; returns last-position logits.
    With a model built with ``impl="kernel"`` this is the path
    that runs the hand-written kernels: flash once per attention block, the
    SSD or RWKV6 scan once per Mamba2 or RWKV6 layer."""

    @torch.inference_mode()
    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return logits[:, -1]

    return prefill


def make_decode_step(model: Model) -> Callable:
    @torch.inference_mode()
    def decode(params, cache, batch, position):
        logits, new_cache = model.decode_step(params, cache, batch, position)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return next_token, new_cache

    return decode
