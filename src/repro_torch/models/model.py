"""Model interface: init / forward / loss / cache / decode (counterpart of
``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` whose methods dispatch to the
family's assembly: the dense transformer, the zamba2 hybrid or the RWKV6
LM.  ``impl`` picks the paths of a full-sequence forward: ``torch`` (plain
PyTorch) or ``kernel`` (every hand-written kernel the family has: flash
attention, the SSD and WKV scans); decode always takes the torch paths.  The loss is
the full cross-entropy; the chunked loss comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from . import rwkv_lm, transformer, zamba

PyTree = Any


def _family_module(cfg: ArchConfig):
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return rwkv_lm
    if cfg.family == "hybrid":
        return zamba
    return transformer


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
    impl: str = "torch"  # torch | kernel

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int, device: DeviceLike = "cuda") -> PyTree:
        """Random parameters drawn on ``device`` from a generator seeded
        with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return _family_module(self.cfg).init_params(gen, self.cfg, dev)

    # -- forward / loss --------------------------------------------------------
    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        return _family_module(self.cfg).forward(params, self.cfg, batch, self.impl)

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
        return ce, {"ce": ce, **aux}

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device: DeviceLike = "cuda") -> PyTree:
        return _family_module(self.cfg).init_cache(self.cfg, batch, max_len, resolve_device(device))

    def decode_step(
        self,
        params: PyTree,
        cache: PyTree,
        batch: Dict[str, torch.Tensor],
        position: int,
    ):
        return _family_module(self.cfg).decode_step(params, self.cfg, cache, batch, position)


def build_model(cfg: ArchConfig, impl: str = "torch") -> Model:
    return Model(cfg, impl)
