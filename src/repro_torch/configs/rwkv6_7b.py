"""RWKV6-7B "Finch" [arXiv:2404.05892]: attention-free, data-dependent
decay linear recurrence. 32L d_model=4096, head_dim 64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536, head_dim=64,
    block_pattern=("rwkv",), mlp_kind="rwkv",
)
