"""starcoder2-15b [dense] — 40L d6144 48H GQA kv=4 d_ff=24576 vocab=49152.

GQA, RoPE, plain-GELU FFN (non-gated). [arXiv:2402.19173; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, head_dim=128,
    attn_kind="full", rope="full", mlp_kind="gelu",
)

SMOKE = ModelConfig(
    arch_id="starcoder2-15b-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, head_dim=12,
    attn_kind="full", rope="full", mlp_kind="gelu", attn_chunk=16,
)
