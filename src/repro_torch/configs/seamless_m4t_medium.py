"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder backbone.

The speech/text frontends are stubbed per the assignment: input_specs()
feeds precomputed frame embeddings to the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="enc_dec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    mlp_kind="gelu", frontend_stub=True,
)
