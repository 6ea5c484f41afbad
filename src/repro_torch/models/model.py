"""Model interface: init / forward / loss / cache / decode (counterpart of
``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` over the dense transformer,
the one family the port runs so far.  The loss is the full cross-entropy;
the chunked loss comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from . import transformer

PyTree = Any


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32.  logits: (..., V), targets: (...) int."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (logz - gold).mean()


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    attn_impl: str = "torch"  # torch | flash

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int, device: DeviceLike = "cuda") -> PyTree:
        """Random parameters drawn on ``device`` from a generator seeded
        with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_params(gen, self.cfg, dev)

    # -- forward / loss --------------------------------------------------------
    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        return transformer.forward(params, self.cfg, batch, self.attn_impl)

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
        return ce, {"ce": ce, **aux}

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device: DeviceLike = "cuda") -> PyTree:
        return transformer.init_cache(self.cfg, batch, max_len, resolve_device(device))

    def decode_step(
        self,
        params: PyTree,
        cache: PyTree,
        batch: Dict[str, torch.Tensor],
        position: int,
    ):
        return transformer.decode_step(params, self.cfg, cache, batch, position)


def build_model(cfg: ArchConfig, attn_impl: str = "torch") -> Model:
    return Model(cfg, attn_impl)
