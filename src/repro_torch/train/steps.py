"""Serve step builders (counterpart of the serving half of
``repro.train.steps``).  The train step comes with the training slice."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model) -> Callable:
    """Prefill: forward over the prompt; returns last-position logits.
    With ``model.attn_impl == "flash"`` this is the path that runs the flash
    kernel, once per layer."""

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
