"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.  A
CUDA request with no card raises: there is no silent CPU fallback, so a
number reported from a run always names the device it ran on.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is CUDA and no
    card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU), so that a
    host-clock timer stopped after it covers the device's work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
