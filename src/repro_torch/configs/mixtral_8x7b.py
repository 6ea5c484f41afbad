"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window attn."""
from .base import ArchConfig, MoEConfig, register

MIXTRAL_8X7B = register(
    ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        head_dim=128,
        sliding_window=4096,
        mlp_act="silu_glu",
        moe=MoEConfig(num_experts=8, top_k=2),
        rope_theta=1000000.0,
        source="arXiv:2401.04088; hf",
    )
)
