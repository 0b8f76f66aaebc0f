"""kimi-k2-1t-a32b [moe] — 61L d7168 64H GQA kv=8 d_ff_expert=2048 vocab=163840.

Trillion-parameter MoE: 384 routed experts top-8 + 1 shared, first layer
dense (d_ff 18432). Assignment-table numbers (GQA kv=8). [arXiv:2501.kimi2]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432, vocab=163840, head_dim=112,
    attn_kind="full", rope="full",
    n_experts=384, n_shared_experts=1, top_k=8, d_ff_expert=2048,
    n_dense_layers=1, d_ff_dense=18432, mlp_kind="swiglu",
)

SMOKE = ModelConfig(
    arch_id="kimi-k2-1t-a32b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    attn_kind="full", rope="full",
    n_experts=8, n_shared_experts=1, top_k=2, d_ff_expert=32,
    n_dense_layers=1, d_ff_dense=128, mlp_kind="swiglu", attn_chunk=16,
)
