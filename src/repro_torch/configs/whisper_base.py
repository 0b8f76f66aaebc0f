"""whisper-base [audio] — 6L enc + 6L dec, d512 8H d_ff=2048 vocab=51865.

Encoder-decoder; conv frontend STUBBED — input_specs() provides precomputed
frame embeddings (B, frames, d). [arXiv:2212.04356]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base", family="audio",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    attn_kind="full", rope="none", mlp_kind="gelu", frame_ratio=4,
)

SMOKE = ModelConfig(
    arch_id="whisper-base-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    attn_kind="full", rope="none", mlp_kind="gelu", frame_ratio=4,
    attn_chunk=16,
)
