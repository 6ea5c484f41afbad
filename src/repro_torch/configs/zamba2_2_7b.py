"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + shared attention block.

54 Mamba2 layers with a single shared transformer (attention+MLP) block
applied every 6 layers (the public model alternates two shared blocks with
LoRA adapters; we use one shared block — noted in DESIGN.md
§Arch-applicability)."""
from .base import ArchConfig, SSMConfig, register

ZAMBA2_2_7B = register(
    ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        head_dim=80,
        mlp_act="gelu_glu",
        ssm=SSMConfig(state_dim=64, expand=2, head_dim=64, chunk=128, n_groups=1),
        shared_attn_every=6,
        source="arXiv:2411.15242; hf",
    )
)
