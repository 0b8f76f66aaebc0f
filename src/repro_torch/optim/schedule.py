"""LR schedules (pure functions of step): the port of
``repro/optim/schedule.py``."""
from __future__ import annotations

import math


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1):
    """step -> lr: linear from 0 to ``peak_lr`` over ``warmup`` steps,
    then a cosine down to ``floor_frac`` x ``peak_lr`` at ``total``, held
    there after.  ``step`` is an int or a 0-d tensor; the result a float."""
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(1, warmup)
        prog = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
        return peak_lr * (floor_frac + (1 - floor_frac) *
                          0.5 * (1 + math.cos(math.pi * prog)))
    return lr
