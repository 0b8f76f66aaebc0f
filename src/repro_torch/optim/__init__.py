"""The optimizer of the port: AdamW with float32 moments, global-norm
clipping, the warmup-cosine schedule (``repro/optim``, ported)."""
from .adamw import AdamWConfig, adamw_update, init_opt_state
from .grad_utils import clip_by_global_norm, global_norm
from .schedule import warmup_cosine

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "warmup_cosine",
           "clip_by_global_norm", "global_norm"]
