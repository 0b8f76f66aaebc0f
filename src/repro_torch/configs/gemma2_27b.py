"""gemma2-27b [dense] — 46L d4608 32H GQA kv=16 d_ff=36864 vocab=256000.

Local(4096)+global alternating attention, attn logit softcap 50, final
logit softcap 30, GeGLU. [arXiv:2408.00118; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab=256000, head_dim=128,
    attn_kind="local_global", window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    mlp_kind="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="gemma2-27b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    attn_kind="local_global", window=32,
    attn_softcap=50.0, logit_softcap=30.0,
    mlp_kind="geglu", tie_embeddings=True, attn_chunk=16,
)
