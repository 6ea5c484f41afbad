"""TF32 rounding as the port's tensor-core kernels do it, for their CPU
mirrors (``attention/ref.py``, ``rwkv6/ref.py``): a float32 value splits
into hi (its low 13 mantissa bits cleared) and lo = tf32(x - hi), and a
float32 product is formed from TF32 operands as ``wgmma`` forms it."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, half away from zero (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): x = hi + lo to about 2^-22 relative, both TF32 values."""
    hi = tf32_hi(x)
    return hi, tf32_rna(x - hi)


# The TF32 products each mode sums: a's part times b's part.
TERMS = {
    "one": ("hh",),
    "split": ("hh", "hl", "lh"),  # the lo.lo term, below 2^-22 |a||b|, dropped
    "split_no_hl": ("hh", "lh"),
    "split_no_lh": ("hh", "hl"),
}


def product(a: torch.Tensor, b: torch.Tensor, tf32: Optional[str]) -> torch.Tensor:
    """a @ b in float32 as a kernel's wgmma forms it: ``None`` exact
    operands, ``"one"`` one TF32 product (hi.hi), ``"split"`` three
    (hi.hi + hi.lo + lo.hi), ``"split_no_hl"`` / ``"split_no_lh"`` the
    split with hi.lo / lo.hi dropped as well."""
    if tf32 is None:
        return a @ b
    if tf32 not in TERMS:
        raise ValueError(f"tf32 must be None or one of {sorted(TERMS)}, not {tf32!r}")
    (ah, al), (bh, bl) = split(a), split(b)
    a_part, b_part = {"h": ah, "l": al}, {"h": bh, "l": bl}
    terms = [a_part[x] @ b_part[y] for x, y in TERMS[tf32]]
    return sum(terms[1:], terms[0])
