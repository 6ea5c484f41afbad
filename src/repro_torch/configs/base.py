"""Architecture configuration system (the port's own copy of
``repro.configs.base``, kept field-for-field identical so that
``param_count()`` and ``reduced()`` agree with the JAX package).

Every assigned architecture is a frozen :class:`ArchConfig`; reduced
("smoke") variants are derived with :meth:`ArchConfig.reduced`.  Configs are
registered by id and selectable via ``--arch`` in the launchers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    # d_ff of each expert (the ArchConfig.d_ff refers to the per-expert width
    # for MoE archs, matching the public configs).


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128  # SSD chunk length
    n_groups: int = 1  # B/C projection groups (Mamba2)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # low-rank size of the data-dependent decay (Finch)
    gate_lora: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    # attention
    attn_bias: bool = False  # qkv bias (Qwen-style)
    sliding_window: Optional[int] = None  # SWA width (Mixtral)
    rope_theta: float = 10000.0
    # block structure
    mlp_act: str = "silu_glu"  # silu_glu | gelu_glu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    parallel_block: bool = False  # Command-R style parallel attn+MLP
    tied_embeddings: bool = False
    # mixtures / ssm / rwkv
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    shared_attn_every: int = 0  # Zamba2: shared attention block interval
    # modality frontends (STUB: input_specs provides precomputed embeddings)
    frontend: str = "none"  # none | audio | vlm
    n_codebooks: int = 1  # MusicGen EnCodec codebooks
    num_patches: int = 256  # VLM stub: visual tokens prepended
    # numerics
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # notes for DESIGN.md provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding / lm_head can
        shard over the tensor-parallel axis (standard practice; the pad ids
        are never emitted by the tokenizer / data pipeline)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling: SSM / hybrid / sliding-window."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qkv = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.family == "ssm" and self.rwkv is not None:
            per_layer = 4 * d * d + 2 * d * ff  # r,k,v,o + channel mix
        elif self.ssm is not None and self.family in ("ssm", "hybrid"):
            d_in = self.ssm.expand * d
            # in_proj (x, z) + dt/B/C projections + out_proj
            per_layer = 2 * d * d_in + d * 2 * self.ssm.n_groups * self.ssm.state_dim + d_in * d
        else:
            per_layer = qkv
        glu = 3 if self.mlp_act.endswith("_glu") else 2
        if self.moe is not None:
            per_layer += self.moe.num_experts * glu * d * ff + d * self.moe.num_experts
        elif self.family == "ssm" and self.rwkv is not None:
            pass  # channel mix already counted
        elif self.ssm is None:
            per_layer += glu * d * ff
        if self.shared_attn_every:
            shared = qkv + 3 * d * ff
        else:
            shared = 0
        embed = V * d * (1 if self.tied_embeddings else 2) * self.n_codebooks
        return self.n_layers * per_layer + shared + embed

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        glu = 3 if self.mlp_act.endswith("_glu") else 2
        inactive = (self.moe.num_experts - self.moe.top_k) * glu * d * ff
        return self.param_count() - self.n_layers * inactive

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.shared_attn_every else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=128,
            head_dim=16,
            sliding_window=8 if self.sliding_window else None,
            num_patches=8,
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, num_experts=4, top_k=2)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state_dim=8, head_dim=16, chunk=8)
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, gate_lora=8)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        return replace(self, name=self.name + "-smoke", **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from . import _load_all  # late import to populate registry

    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    from . import _load_all

    _load_all()
    return dict(_REGISTRY)


def cells(arch: ArchConfig) -> Tuple[str, ...]:
    """The shape cells that apply to an architecture (skips noted in
    DESIGN.md §Arch-applicability: long_500k needs sub-quadratic attention)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.supports_long_context:
        out.append("long_500k")
    return tuple(out)
