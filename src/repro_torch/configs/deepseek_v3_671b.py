"""DeepSeek-V3 671B [arXiv:2412.19437]: MLA + 1 shared / 256 routed top-8 MoE.

Assignment: 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
First 3 layers are dense (d_ff 18432); MoE from layer 3 on. MLA with
kv_lora=512, q_lora=1536, rope_head=64. (MTP head omitted: the assigned
shape set exercises the backbone.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280, head_dim=128,
    attn_impl="mla", q_lora_rank=1536, kv_lora_rank=512,
    rope_head_dim=64, v_head_dim=128,
    moe_n_experts=256, moe_top_k=8, moe_n_shared=1, moe_d_ff=2048,
    moe_layer_start=3,
    opt_moment_dtype="int8",  # fits 512x16GB HBM (see DESIGN.md)
)
