"""Qwen2-VL-2B [arXiv:2409.12191]: GQA decoder backbone with M-RoPE.

Dynamic-resolution vision tower is stubbed per the assignment:
input_specs() feeds precomputed patch embeddings + 3D positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6, frontend_stub=True, tie_embeddings=True,
)
