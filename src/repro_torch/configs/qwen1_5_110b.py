"""Qwen1.5-110B [hf:Qwen family]: dense GQA with QKV bias."""
from .base import ArchConfig, register

QWEN15_110B = register(
    ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab_size=152064,
        head_dim=128,
        attn_bias=True,  # QKV bias
        mlp_act="silu_glu",
        rope_theta=1000000.0,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
)
