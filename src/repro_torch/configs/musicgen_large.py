"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens.

Modality frontend is a STUB: input_specs() provides precomputed frame
embeddings (the sum of the 4 codebook embeddings after the delay pattern);
the backbone predicts all 4 codebooks per frame (mean CE across codebooks).
"""
from .base import ArchConfig, register

MUSICGEN_LARGE = register(
    ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        head_dim=64,
        mlp_act="gelu",
        norm="layernorm",
        frontend="audio",
        n_codebooks=4,
        source="arXiv:2306.05284; hf",
    )
)
