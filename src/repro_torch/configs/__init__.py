"""The architecture configs the port serves, plus shapes.

Registered: the dense decoder family (the port's transformer), the hybrid
zamba2-2.7b (``models/zamba.py``) and the RWKV family's rwkv6-3b
(``models/rwkv_lm.py``).  The MoE and modality configs join as their
models are ported.
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
    "rwkv6_3b",
    "zamba2_2_7b",
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
