"""Model configuration schema shared by every architecture config.

One frozen dataclass describes any member of the supported families:
dense decoder LMs (GQA/MQA, optional bias + qk_norm), MLA + MoE
(DeepSeek-V2/V3), encoder-decoder (Seamless-M4T backbone), hybrid
RG-LRU/local-attention (RecurrentGemma), M-RoPE VLM backbones (Qwen2-VL),
and attention-free RWKV6 — plus the paper's own CNNs (see
``repro_torch.core.workload.CNN_MODELS``, which have their own schema).
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "enc_dec", "hybrid", "vlm", "ssm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0                   # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False                 # M-RoPE (Qwen2-VL): 3-section rotary
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    window: int = 0                     # >0: sliding-window (local) attention
    mlp_kind: Literal["swiglu", "gelu", "geglu", "rwkv"] = "swiglu"

    # Layer pattern: tuple cycled over the depth, e.g. Griffin's
    # ("rglru", "rglru", "attn_local"). Default: all attention.
    block_pattern: tuple[str, ...] = ("attn",)

    # MoE (DeepSeek-style shared + routed, top-k)
    moe_n_experts: int = 0
    moe_top_k: int = 0
    moe_n_shared: int = 0
    moe_d_ff: int = 0
    moe_layer_start: int = 0            # leading dense layers
    moe_capacity_factor: float = 1.25

    # MLA (DeepSeek)
    attn_impl: Literal["gqa", "mla"] = "gqa"
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # Encoder-decoder
    n_enc_layers: int = 0

    # Recurrent
    lru_width: int = 0                  # RG-LRU recurrence width
    conv1d_width: int = 4

    # Modality frontend stub: inputs are precomputed frame/patch embeddings
    # of this dimension instead of token ids (seamless / qwen2-vl).
    frontend_stub: bool = False

    tie_embeddings: bool = False

    # Numerics / optimizer defaults (overridable per launch)
    dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"   # deepseek-v3 uses int8 (see optim/)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.attn_impl == "mla" and self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)

    # -- layer-pattern helpers -------------------------------------------
    def block_kind(self, i: int) -> str:
        """Kind of decoder layer i: attn | attn_local | rglru | rwkv,
        suffixed with 'moe'/'mla' flavors where applicable."""
        base = self.block_pattern[i % len(self.block_pattern)]
        if self.moe_n_experts and i >= self.moe_layer_start:
            base = {"attn": "moe", "mla": "mla_moe"}.get(base, base + "_moe")
        if self.attn_impl == "mla":
            base = base.replace("attn", "mla").replace("moe", "mla_moe") \
                if base in ("attn", "moe") else base
        return base

    def layer_kinds(self) -> list[str]:
        return [self.block_kind(i) for i in range(self.n_layers)]

    @property
    def sub_quadratic(self) -> bool:
        """True if no full-attention layer (long_500k is runnable)."""
        kinds = set(self.layer_kinds())
        return not any(k in ("attn", "moe", "mla", "mla_moe") for k in kinds)

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    n_layers = max(2, min(4, len(cfg.block_pattern) * 2))
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, 4)
    kw = dict(
        n_layers=n_layers, d_model=64, n_heads=heads, n_kv_heads=kv,
        d_ff=128, vocab=128, head_dim=16,
    )
    if cfg.moe_n_experts:
        kw.update(moe_n_experts=4, moe_top_k=2,
                  moe_n_shared=min(cfg.moe_n_shared, 1), moe_d_ff=32,
                  moe_layer_start=min(cfg.moe_layer_start, 1))
    if cfg.attn_impl == "mla":
        kw.update(q_lora_rank=32 if cfg.q_lora_rank else 0, kv_lora_rank=32,
                  rope_head_dim=8, v_head_dim=16)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.window:
        kw.update(window=32)
    if cfg.mrope:
        kw.update(mrope_sections=(2, 3, 3))  # sums to head_dim/2 = 8
    return cfg.scaled(**kw)
