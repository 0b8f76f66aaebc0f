"""deepseek-v2-236b [moe] — 60L d5120 128H d_ff_expert=1536 vocab=102400.

MLA: kv_lora_rank=512, q_lora_rank=1536, qk_nope=128, qk_rope=64, v=128.
MoE: 2 shared + 160 routed experts, top-6; first layer dense (d_ff 12288).
[arXiv:2405.04434; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    attn_kind="mla", rope="full",
    kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    n_dense_layers=1, d_ff_dense=12288, mlp_kind="swiglu",
)

SMOKE = ModelConfig(
    arch_id="deepseek-v2-236b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    attn_kind="mla", rope="full",
    kv_lora_rank=32, q_lora_rank=48,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, n_shared_experts=2, top_k=2, d_ff_expert=32,
    n_dense_layers=1, d_ff_dense=128, mlp_kind="swiglu", attn_chunk=16,
)
