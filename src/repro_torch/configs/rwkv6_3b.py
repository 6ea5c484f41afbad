"""RWKV6-3B "Finch" [arXiv:2404.05892]: attention-free, data-dependent decay."""
from .base import ArchConfig, RWKVConfig, register

RWKV6_3B = register(
    ArchConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # d_model / rwkv.head_dim
        n_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        head_dim=64,
        mlp_act="relu2",  # RWKV channel-mix uses squared ReLU
        norm="layernorm",
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64),
        source="arXiv:2404.05892; hf",
    )
)
