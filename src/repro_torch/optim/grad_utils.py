"""Global-norm clipping: the port of ``repro/optim/grad_utils.py:15-25``.

The JAX module's int8 compression (``int8_compress``, ``compressed_psum``)
serves its multi-device data-parallel path and is not ported yet (ROADMAP,
the training queue).  Gradients are a dict of name -> tensor.
"""
from __future__ import annotations

import torch


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32 (0-d)."""
    total = None
    for g in grads.values():
        sq = g.detach().to(torch.float32).pow(2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), each in its own
    dtype, the scaling done in float32; the global norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm
