"""Phi-3.5-MoE 42B (A6.6B) [hf:microsoft/Phi-3.5-MoE-instruct]: 16-expert top-2."""
from .base import ArchConfig, MoEConfig, register

PHI35_MOE_42B = register(
    ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        head_dim=128,
        mlp_act="silu_glu",
        moe=MoEConfig(num_experts=16, top_k=2),
        source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    )
)
