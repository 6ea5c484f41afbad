"""The architecture configs the port serves, plus shapes: all eleven of the
JAX package's.

The transformer (``models/transformer.py``) takes the dense decoders, the
mixture-of-experts configs (mixtral-8x7b, phi3.5-moe-42b-a6.6b; the expert
layer in ``models/moe.py``) and the two modality configs with stub
frontends (internvl2-1b: patch embeddings prepended; musicgen-large: audio
frame embeddings in, one head per codebook).  The hybrid zamba2-2.7b has
``models/zamba.py`` and the RWKV family's rwkv6-3b ``models/rwkv_lm.py``.
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
    "musicgen_large",
    "internvl2_1b",
    "rwkv6_3b",
    "zamba2_2_7b",
    "mixtral_8x7b",
    "phi3_5_moe_42b",
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
