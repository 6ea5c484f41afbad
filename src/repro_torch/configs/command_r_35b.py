"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]: GQA, no bias,
parallel attention+MLP block."""
from .base import ArchConfig, register

COMMAND_R_35B = register(
    ArchConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        head_dim=128,
        attn_bias=False,
        parallel_block=True,
        mlp_act="silu_glu",
        norm="layernorm",
        tied_embeddings=True,
        rope_theta=10000.0,
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )
)
