"""Gradient compression with error feedback (counterpart of
``repro.optim.compression``), on tensors.

Two compressors, each with an error-feedback residual that is added back
the next step so that compression error does not bias the optimizer:

* ``int8`` — per-tensor symmetric quantization (a quarter of the bytes);
* ``topk`` — magnitude top-k sparsification (``topk_frac`` of the entries).

The codes equal the JAX package's: the same float32 scale, and rounding
half to even in both.  ``torch.topk`` and ``lax.top_k`` may order ties
differently, which moves no threshold.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree

PyTree = Any


class CompressionState(NamedTuple):
    residual: PyTree  # error-feedback accumulator (float32, like grads)


def init_state(grads_like: PyTree) -> CompressionState:
    return CompressionState(residual=tree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def sparsify_topk(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top ``frac`` of the entries by magnitude, as a dense masked
    tensor (the mask is what the error feedback and the traffic model need)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros((), dtype=x.dtype, device=x.device))


def compress_with_feedback(
    grads: PyTree,
    state: CompressionState,
    method: str = "int8",
    topk_frac: float = 0.01,
) -> Tuple[PyTree, CompressionState, PyTree]:
    """Returns (compressed-then-decompressed grads, new state, wire tree);
    the error (original - sent) goes into the next step's residual."""
    if method not in ("int8", "topk", "none"):
        raise ValueError(f"unknown compression method {method}")

    def one(g, r):
        gf = g.float() + r
        if method == "int8":
            q, scale = quantize_int8(gf)
            sent = dequantize_int8(q, scale)
            wire = (q, scale)
        elif method == "topk":
            sent = sparsify_topk(gf, topk_frac)
            wire = sent
        else:
            sent = gf
            wire = gf
        return sent, gf - sent, wire

    out = [one(g, r) for g, r in zip(tree.leaves(grads), tree.leaves(state.residual), strict=True)]
    sent = tree.unflatten(grads, [o[0] for o in out])
    resid = tree.unflatten(grads, [o[1] for o in out])
    wire = tree.unflatten(grads, [o[2] for o in out])
    return sent, CompressionState(residual=resid), wire


def wire_bytes(wire: PyTree) -> int:
    """Bytes of the compressed representation (for the collective model)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree.leaves(wire))
