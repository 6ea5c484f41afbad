"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA decoder, squared-ReLU MLP."""
from .base import ArchConfig, register

NEMOTRON_4_340B = register(
    ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        head_dim=192,
        mlp_act="relu2",  # squared ReLU, non-gated
        norm="layernorm",
        rope_theta=10000.0,
        source="arXiv:2402.16819; unverified",
    )
)
