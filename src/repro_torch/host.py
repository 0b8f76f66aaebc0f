"""Host-side buffers for one pattern, in numpy.

The same draws as the JAX package (``repro.core.engine.make_host_buffers``
and ``repro.core.backends.keep_last_mask``): one ``default_rng(seed)`` per
pattern, ``src`` drawn first and ``vals`` second, so both packages feed
their devices bit-identical inputs and their outputs can be compared by
digest.  Draws are float32 at every dtype, as in the reference;
``as_dtype`` makes the operand of a run's dtype from them.
"""
from __future__ import annotations

import numpy as np
import torch

from .pattern import Pattern


def keep_last_mask(idx: np.ndarray) -> np.ndarray:
    """Last-write-wins keep mask: True at the last occurrence of each
    distinct index value, False elsewhere.

    Pattern indices are static, so this runs once on the host and never
    inside a timed region (DESIGN.md §2.1).
    """
    idx = np.asarray(idx)
    n = idx.shape[0]
    if n == 0:
        return np.zeros((0,), bool)
    order = np.argsort(idx, kind="stable")       # stable: ties keep position
    sidx = idx[order]
    is_last = np.concatenate([sidx[1:] != sidx[:-1], np.ones((1,), bool)])
    keep = np.zeros((n,), bool)
    keep[order[is_last]] = True
    return keep


def make_host_buffers(pattern: Pattern, row_width: int, seed: int = 0):
    """Host-side buffers for one pattern: (src, abs_idx, vals, keep).

    ``src`` is the (footprint, row_width) float32 table, ``abs_idx`` the
    flattened (count*index_len,) int32 absolute indices, ``vals`` the
    scatter payload (None for gathers), and ``keep`` the last-write-wins
    mask over ``abs_idx`` (None for gathers).
    """
    rng = np.random.default_rng(seed)
    f = pattern.footprint()
    abs_idx = pattern.absolute_indices().reshape(-1)
    src = rng.standard_normal((f, row_width), dtype=np.float32)
    if pattern.kind == "gather":
        return src, abs_idx, None, None
    vals = rng.standard_normal((abs_idx.shape[0], row_width),
                               dtype=np.float32)
    return src, abs_idx, vals, keep_last_mask(abs_idx)


def as_dtype(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The float32 draw ``x`` as a CPU tensor of ``dtype``: the one place
    a 16-bit operand is made.  ``torch.from_numpy(x).to(dtype)`` rounds to
    nearest even, as ``jnp.asarray(x, dtype)`` does, and gives the same
    bits for bfloat16 and float16 (-0.0, overflow to inf and subnormals
    included), so both packages' operands, and their gathers' and stores'
    digests, agree bit for bit.  float32 passes through uncopied."""
    return torch.from_numpy(x).to(dtype)
