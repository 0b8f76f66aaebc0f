"""recurrentgemma-9b [hybrid] — 38L d4096 16H MQA kv=1 d_ff=12288 vocab=256000.

Griffin blocks: RG-LRU temporal mixing + local attention (window 2048) in a
(rec, rec, attn) repeating pattern — "1:2" attention:recurrent.
[arXiv:2402.19427]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    attn_kind="local_global", window=2048, rope="full",
    mlp_kind="geglu", lru_width=4096,
    block_pattern=("rec", "rec", "attn"), tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=16,
    attn_kind="local_global", window=16, rope="full",
    mlp_kind="geglu", lru_width=64,
    block_pattern=("rec", "rec", "attn"), tie_embeddings=True, attn_chunk=16,
)
