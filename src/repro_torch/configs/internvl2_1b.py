"""InternVL2-1B [arXiv:2404.16821]: InternViT frontend (STUB) + Qwen2-0.5B-class
decoder backbone (24L, d=896, 14H GQA kv=2)."""
from .base import ArchConfig, register

INTERNVL2_1B = register(
    ArchConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        head_dim=64,
        attn_bias=True,
        mlp_act="silu_glu",
        tied_embeddings=True,
        frontend="vlm",
        num_patches=256,
        rope_theta=1000000.0,
        source="arXiv:2404.16821; hf",
    )
)
