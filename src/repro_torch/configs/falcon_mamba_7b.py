"""falcon-mamba-7b [ssm] — 64L d4096 attention-free, vocab=65024, state=16.

Mamba-1 blocks: d_inner = 2*d_model, d_conv=4, selective scan.
[arXiv:2410.05355]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024,
    attn_kind="none", rope="none", mlp_kind="swiglu",
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)

SMOKE = ModelConfig(
    arch_id="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256,
    attn_kind="none", rope="none", mlp_kind="swiglu",
    ssm_state=8, ssm_conv=4, ssm_expand=2,
)
