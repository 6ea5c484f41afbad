"""Model interface: init / forward / loss / cache / decode (counterpart of
``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` whose methods dispatch to the
family's assembly: the transformer (dense, MoE, audio and VLM configs), the
zamba2 hybrid or the RWKV6 LM.  The loss handles the modality quirks (the
VLM patch prefix, MusicGen's codebook heads) and adds 0.01 x the MoE
auxiliary loss, as JAX's does.  ``impl`` picks the paths of a full-sequence forward: ``torch`` (plain
PyTorch, the training path, whose attention on the card runs the flash
kernels with their backward pass for bf16 at a head dim they take,
``layers.takes_flash_backward``) or ``kernel`` (every hand-written kernel the
family has: flash attention, the SSD and WKV scans; forward only, as the
scans have no backward); decode always takes the torch paths.  ``remat``
is the layer-rematerialisation policy of training, and ``loss_chunk`` turns
on the chunked cross-entropy, which never holds the (B, S, V) logits at
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from . import rwkv_lm, transformer, zamba
from .layers import shard_index

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
    if hasattr(logits, "placements"):  # a DTensor (the dry-run)
        return _token_ce_on_shards(logits, targets)
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


def _token_ce_on_shards(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """:func:`_token_ce` of DTensor logits, Megatron's vocabulary-parallel
    CE: every (..., V) quantity stays on each rank's shards, and only the
    per-position max, sum of exponentials and gold logit (the gold as
    JAX's one-hot sum over the rank's slice of the vocabulary; DTensor's
    gather along a sharded vocabulary is unsound) are reduced over the mesh
    dimensions that shard the vocabulary.  Left to DTensor's own rules, the
    card's torch made a (batch, sequence, vocabulary) float32 tensor whole
    on each rank in the CE's backward (67 GB on command-r-35b's train cell
    at one microbatch)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    vdim = logits.dim() - 1
    lay = [pl if isinstance(pl, Shard) else Replicate() for pl in logits.placements]
    rows = [Replicate() if pl.is_shard(vdim) else pl for pl in lay]
    partial = lambda op: [Partial(op) if pl.is_shard(vdim) else r for pl, r in zip(lay, rows)]
    logits = logits.redistribute(mesh, lay)
    index, size = shard_index(logits, vdim)

    m = local_map(lambda l: l.amax(dim=-1), out_placements=partial("max"), in_placements=(lay,),
                  device_mesh=mesh)(logits.detach()).redistribute(mesh, rows)

    def parts(l, t, m_):
        ids = torch.arange(index * size, (index + 1) * size, device=l.device)
        return torch.exp(l - m_[..., None]).sum(dim=-1), (l * (ids == t[..., None])).sum(dim=-1)

    sumexp, gold = local_map(parts, out_placements=(partial("sum"), partial("sum")),
                             in_placements=(lay, rows, rows), device_mesh=mesh)(
        logits, targets.redistribute(mesh, rows), m)
    return torch.log(sumexp.redistribute(mesh, rows)) + m - gold.redistribute(mesh, rows)


def _positions(logits: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``logits[:, lo:hi]``.  DTensor logits (the dry-run) whose sequence is
    not sharded are sliced on each rank's shards, so the slice's backward
    is local too and never meets DTensor's rule for ``slice_backward``."""
    if not hasattr(logits, "placements") or any(pl.is_shard(1) for pl in logits.placements):
        return logits[:, lo:hi]
    from torch.distributed.tensor.experimental import local_map

    pl = list(logits.placements)  # a list: local_map reads a tuple as one placement list per output
    return local_map(lambda t: t[:, lo:hi], out_placements=pl, in_placements=(pl,),
                     device_mesh=logits.device_mesh)(logits)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32.  logits: (..., V), targets: (...) int."""
    return _token_ce(logits, targets).mean()


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    impl: str = "torch"  # torch | kernel
    remat: str = "block"  # block | dots | none
    # chunked cross-entropy: logits and CE over sequence chunks of this size,
    # each chunk's logits recomputed in the backward pass
    loss_chunk: Optional[int] = None
    # ndim -> DTensor placements: the loss redistributes DTensor logits to
    # them, so that the vocab-parallel CE stays sharded (set by the dry-run)
    logits_sharding: Optional[Callable[[int], Any]] = None

    # -- parameters ----------------------------------------------------------
    def init(self, seed: int, device: DeviceLike = "cuda") -> PyTree:
        """Random parameters drawn on ``device`` from a generator seeded
        with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return _family_module(self.cfg).init_params(gen, self.cfg, dev)

    def init_shapes(self) -> PyTree:
        """The parameter tree on the meta device: shapes and dtypes, nothing
        allocated (the dry-run's counterpart of ``jax.eval_shape``)."""
        return _family_module(self.cfg).init_params(torch.Generator(), self.cfg, torch.device("meta"))

    # -- forward / loss --------------------------------------------------------
    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        return _family_module(self.cfg).forward(params, self.cfg, batch, self.impl, self.remat)

    def _targets_and_hidden_slice(self, batch: Dict[str, torch.Tensor], seq_len: int):
        """((lo, hi) positions of the outputs, targets) aligned for next-token
        prediction: MusicGen predicts every codebook of the next frame; the
        VLM's prediction of token i sits at P - 1 + i, after the patches."""
        cfg = self.cfg
        if cfg.n_codebooks > 1:
            return (0, seq_len - 1), batch["targets"][:, 1:]
        if cfg.frontend == "vlm":
            P = cfg.num_patches
            S = batch["tokens"].shape[1]
            return (P - 1, P - 1 + S - 1), batch["tokens"][:, 1:]
        return (0, seq_len - 1), batch["tokens"][:, 1:]

    def _constrain(self, logits: torch.Tensor) -> torch.Tensor:
        """DTensor logits redistributed to ``logits_sharding`` (JAX's
        ``with_sharding_constraint``); other logits as they are."""
        if self.logits_sharding is None or not hasattr(logits, "placements"):
            return logits
        return logits.redistribute(logits.device_mesh, self.logits_sharding(logits.ndim))

    @staticmethod
    def _with_aux(ce: torch.Tensor, aux: Dict[str, torch.Tensor]):
        loss = ce
        if "moe_aux_loss" in aux:
            loss = loss + 0.01 * aux["moe_aux_loss"]
        return loss, {"ce": ce, **aux}

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        if self.loss_chunk is not None:
            return self._chunked_loss(params, batch)
        logits, aux = self.forward(params, batch)
        logits = self._constrain(logits)
        (lo, hi), targets = self._targets_and_hidden_slice(batch, logits.shape[1])
        with obs.trace("model.loss"):
            ce = cross_entropy(_positions(logits, lo, hi), targets)
        return self._with_aux(ce, aux)

    def _chunked_loss(self, params: PyTree, batch: Dict[str, torch.Tensor]):
        """CE over sequence chunks of ``loss_chunk`` positions (and the
        remainder): each chunk's (B, chunk, V) logits are made inside
        ``torch.utils.checkpoint`` while autograd records, so the (B, S, V)
        logits never exist at once."""
        h, aux = _family_module(self.cfg).forward(
            params, self.cfg, batch, self.impl, self.remat, return_hidden=True
        )
        (lo, hi), targets = self._targets_and_hidden_slice(batch, h.shape[1])
        h = h[:, lo:hi]
        T = h.shape[1]
        C = min(self.loss_chunk, T)

        def head_ce(h_c, t_c):
            logits = self._constrain(transformer.logits_from_hidden(params, self.cfg, h_c))
            with obs.trace("model.loss"):
                return _token_ce(logits, t_c).sum()

        if torch.is_grad_enabled():
            chunk_ce = lambda h_c, t_c: torch.utils.checkpoint.checkpoint(
                head_ce, h_c, t_c, use_reentrant=False)
        else:
            chunk_ce = head_ce
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for start in range(0, T, C):
            total = total + chunk_ce(h[:, start : start + C], targets[:, start : start + C])
        ce = total / targets.numel()  # every codebook's target counts
        return self._with_aux(ce, aux)

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device: DeviceLike = "cuda") -> PyTree:
        return _family_module(self.cfg).init_cache(self.cfg, batch, max_len, resolve_device(device))

    def cache_shapes(self, batch: int, max_len: int) -> PyTree:
        """The decode cache on the meta device (shapes and dtypes only)."""
        return _family_module(self.cfg).init_cache(self.cfg, batch, max_len, torch.device("meta"))

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
    """A random batch of the family's structure (tests, smoke runs), from a
    generator seeded with ``seed`` on ``device``: tokens; for audio, frame
    embeddings and per-codebook targets in their place; for VLM, patch
    embeddings beside the tokens."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = transformer._torch_dtype(cfg.activation_dtype)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
    if cfg.frontend == "audio":
        return {
            "frame_embeds": normal(batch, seq, cfg.d_model),
            "targets": torch.randint(0, cfg.vocab_size, (batch, seq, cfg.n_codebooks),
                                     generator=gen, device=dev),
        }
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)}
    if cfg.frontend == "vlm":
        out["patch_embeds"] = normal(batch, cfg.num_patches, cfg.d_model)
    return out
