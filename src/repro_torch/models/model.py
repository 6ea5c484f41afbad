"""Model interface: init / forward / loss / cache / decode (counterpart of
``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` whose methods dispatch to the
family's assembly: the dense transformer, the zamba2 hybrid or the RWKV6
LM.  ``impl`` picks the paths of a full-sequence forward: ``torch`` (plain
PyTorch, the training path) or ``kernel`` (every hand-written kernel the
family has: flash attention, the SSD and WKV scans; forward only, as the
kernels have no backward); decode always takes the torch paths.  ``remat``
is the layer-rematerialisation policy of training, and ``loss_chunk`` turns
on the chunked cross-entropy, which never holds the (B, S, V) logits at
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

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


def _token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Next-token CE per position, in f32.  logits: (..., V), targets: (...) int."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32.  logits: (..., V), targets: (...) int."""
    return _token_ce(logits, targets).mean()


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    impl: str = "torch"  # torch | kernel
    remat: str = "block"  # block | none (JAX's "dots" serves the dry-run only)
    # chunked cross-entropy: logits and CE over sequence chunks of this size,
    # each chunk's logits recomputed in the backward pass
    loss_chunk: Optional[int] = None

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int, device: DeviceLike = "cuda") -> PyTree:
        """Random parameters drawn on ``device`` from a generator seeded
        with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return _family_module(self.cfg).init_params(gen, self.cfg, dev)

    # -- forward / loss --------------------------------------------------------
    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        return _family_module(self.cfg).forward(params, self.cfg, batch, self.impl, self.remat)

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        if self.loss_chunk is not None:
            return self._chunked_loss(params, batch)
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
        return ce, {"ce": ce, **aux}

    def _chunked_loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        """CE over sequence chunks of ``loss_chunk`` positions (and the
        remainder): each chunk's (B, chunk, V) logits are made inside
        ``torch.utils.checkpoint`` while autograd records, so the (B, S, V)
        logits never exist at once."""
        h, aux = _family_module(self.cfg).forward(
            params, self.cfg, batch, self.impl, self.remat, return_hidden=True
        )
        targets = batch["tokens"][:, 1:]
        h = h[:, : h.shape[1] - 1]
        T = h.shape[1]
        C = min(self.loss_chunk, T)

        def head_ce(h_c, t_c):
            return _token_ce(transformer.logits_from_hidden(params, self.cfg, h_c), t_c).sum()

        if torch.is_grad_enabled():
            chunk_ce = lambda h_c, t_c: torch.utils.checkpoint.checkpoint(
                head_ce, h_c, t_c, use_reentrant=False)
        else:
            chunk_ce = head_ce
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for start in range(0, T, C):
            total = total + chunk_ce(h[:, start : start + C], targets[:, start : start + C])
        ce = total / targets.numel()
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


def build_model(cfg: ArchConfig, impl: str = "torch", remat: str = "block") -> Model:
    return Model(cfg, impl, remat)


def synthetic_batch(
    cfg: ArchConfig, batch: int, seq: int, seed: int = 0, device: DeviceLike = "cuda"
) -> Dict[str, torch.Tensor]:
    """Random tokens of the right structure for a token LM (tests, smoke
    runs), from a generator seeded with ``seed`` on ``device``."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} is not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)}
