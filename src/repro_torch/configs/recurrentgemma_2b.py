"""RecurrentGemma-2B [arXiv:2402.19427] (Griffin): RG-LRU + local attention,
2 recurrent blocks : 1 local-attention block, window 2048, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "attn_local"), window=2048,
    lru_width=2560, conv1d_width=4, mlp_kind="geglu",
    tie_embeddings=True,
)
