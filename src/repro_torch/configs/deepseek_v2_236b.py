"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA kv_lora=512, 2 shared + 160
routed top-6 MoE. First layer dense (d_ff 12288)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400, head_dim=128,
    attn_impl="mla", q_lora_rank=1536, kv_lora_rank=512,
    rope_head_dim=64, v_head_dim=128,
    moe_n_experts=160, moe_top_k=6, moe_n_shared=2, moe_d_ff=1536,
    moe_layer_start=1,
    opt_moment_dtype="int8",
)
