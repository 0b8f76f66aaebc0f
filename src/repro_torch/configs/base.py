"""ModelConfig: the JAX package's architecture dataclass, copied.

The same fields, defaults and derived counts as ``repro/configs/base.py``
(copied, not imported: the port never imports ``repro``), so a config
module of the JAX package ports verbatim.  ``ARCH_IDS`` lists the architectures the port
runs; any other architecture of the JAX package raises, naming the ROADMAP
item that will port it.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ["falcon-mamba-7b", "llama3-8b", "deepseek-v2-236b", "gemma2-27b",
            "chatglm3-6b", "starcoder2-15b", "recurrentgemma-9b",
            "kimi-k2-1t-a32b", "whisper-base", "internvl2-26b"]

# the JAX package's architectures the port does not run yet: none
NOT_PORTED: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                          # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 -> d_model // n_heads

    # attention flavor
    attn_kind: str = "full"              # full | mla | local_global | none
    rope: str = "full"                   # full | partial | 2d | none
    rope_theta: float = 10000.0
    window: int = 0                      # local attention window
    attn_softcap: float = 0.0            # gemma2: 50.0
    logit_softcap: float = 0.0           # gemma2: 30.0
    mlp_kind: str = "swiglu"             # swiglu | geglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0              # leading dense layers (deepseek/kimi)
    d_ff_dense: int = 0                  # their FFN width
    capacity_factor: float = 1.25
    router_scale: float = 1.0
    moe_impl: str = "gspmd_sort"         # gspmd_sort | ep_shardmap (§Perf)

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                 # 0 -> ceil(d_model/16)

    # RG-LRU hybrid (recurrentgemma)
    lru_width: int = 0
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec","rec","attn")

    # enc-dec (whisper)
    n_enc_layers: int = 0
    frame_ratio: int = 4                 # stub frontend: frames = seq/ratio

    # vlm (internvl)
    n_img_tokens: int = 0

    # numerics / runtime
    dtype: str = "bfloat16"
    remat: str = "block"                 # none | block | full
    scan_layers: bool = True
    attn_chunk: int = 512                # query-chunked attention block

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def is_subquadratic(self) -> bool:
        """Whether the arch runs the 500k context (``long_500k``): its
        mixers keep no cache that grows with every position."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameters (analytic: ``models.zoo.count_params``)."""
        from ..models.zoo import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token runs (a MoE model's top_k experts)."""
        from ..models.zoo import count_params
        return count_params(self, active_only=True)


def shape_skips(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """Why the (arch, shape) cell is skipped, or None: ``long_500k`` only
    for sub-quadratic archs, as the JAX package's ``shape_skips``."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("full-attention arch (global attention layers present): "
                "524k context requires sub-quadratic attention — skipped "
                "per assignment; see DESIGN.md §6")
    return None


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        if arch_id in NOT_PORTED:
            raise NotImplementedError(
                f"{arch_id} is not ported to repro_torch yet (ROADMAP A7)")
        raise ValueError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    return importlib.import_module(
        f"{__package__}.{arch_id.replace('-', '_').replace('.', '_')}")


def get_config(arch_id: str) -> ModelConfig:
    """The full published config."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """A reduced config of the same family, for CPU tests."""
    return _module(arch_id).SMOKE
