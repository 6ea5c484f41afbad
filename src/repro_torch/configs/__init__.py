"""The dense architecture configs the port serves, plus shapes.

Only the dense decoder family is registered here: it is the family that the
port's transformer runs.  The other families join as their models are ported.
"""

import importlib

from .base import (
    ArchConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    all_archs,
    cells,
    get_arch,
)

_MODULES = [
    "nemotron_4_340b",
    "granite_3_8b",
    "command_r_35b",
    "qwen1_5_110b",
    "llama3_70b",
]

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
