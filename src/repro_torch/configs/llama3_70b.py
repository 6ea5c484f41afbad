"""Llama-3-70B [arXiv:2407.21783]: dense GQA workhorse (the 11th config).

Added so the fleet planner's per-config table covers the canonical dense
serving target alongside the MoE / SSM / hybrid families.
"""
from .base import ArchConfig, register

LLAMA3_70B = register(
    ArchConfig(
        name="llama3-70b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        head_dim=128,
        mlp_act="silu_glu",
        rope_theta=500000.0,
        source="arXiv:2407.21783; hf:meta-llama/Meta-Llama-3-70B",
    )
)
