"""internvl2-26b [vlm] — 48L d6144 48H GQA kv=8 d_ff=16384 vocab=92553.

InternLM2-20B language backbone; InternViT frontend STUBBED — input_specs()
provides precomputed patch embeddings (B, n_img_tokens, d).
[arXiv:2404.16821; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128,
    attn_kind="full", rope="full", mlp_kind="swiglu",
    n_img_tokens=256,
)

SMOKE = ModelConfig(
    arch_id="internvl2-26b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    attn_kind="full", rope="full", mlp_kind="swiglu",
    n_img_tokens=8, attn_chunk=16,
)
