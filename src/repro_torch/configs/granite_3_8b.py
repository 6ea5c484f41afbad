"""Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base family]: dense GQA."""
from .base import ArchConfig, register

GRANITE_3_8B = register(
    ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        head_dim=128,
        mlp_act="silu_glu",
        tied_embeddings=True,
        rope_theta=10000.0,
        source="hf:ibm-granite/granite-3.0-2b-base; hf",
    )
)
