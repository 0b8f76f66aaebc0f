"""llama3-8b [dense] — 32L d4096 32H GQA kv=8 d_ff=14336 vocab=128256.

GQA, 128k vocab, RoPE theta 500000. [arXiv:2407.21783]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    attn_kind="full", rope="full", rope_theta=500000.0, mlp_kind="swiglu",
)

SMOKE = ModelConfig(
    arch_id="llama3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=512, head_dim=16,
    attn_kind="full", rope="full", rope_theta=500000.0, mlp_kind="swiglu",
    attn_chunk=16,
)
