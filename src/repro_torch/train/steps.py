"""Serve step builders (counterpart of the serving half of
``repro.train.steps``).  The train step comes with the training slice."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


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
