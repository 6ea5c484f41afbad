"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.  NVIDIA's H100 SXM data sheet:
dense rates, no sparsity, at the full 700 W power limit; a card set below
it runs slower, so each run records its limit beside the numbers."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(kind: str) -> Optional[dict]:
    """The card's peaks, or None for a card not in the table (a metric read
    against an unknown peak is left out, never guessed)."""
    return PEAKS.get(kind)
