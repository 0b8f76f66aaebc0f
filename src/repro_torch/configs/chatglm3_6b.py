"""chatglm3-6b [dense] — 28L d4096 32H GQA kv=2 d_ff=13696 vocab=65024.

RoPE applied to half the head dim ("2d" interleaved rotary), GQA.
[arXiv:2406.12793; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128,
    attn_kind="full", rope="2d", mlp_kind="swiglu",
)

SMOKE = ModelConfig(
    arch_id="chatglm3-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    attn_kind="full", rope="2d", mlp_kind="swiglu", attn_chunk=16,
)
