"""Granite-34B-Code [arXiv:2405.04324]: deep MQA (kv=1) decoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    mlp_kind="gelu",  # gpt_bigcode-style 2-matrix MLP (param count matches 34B)
)
