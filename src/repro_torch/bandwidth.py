"""Bandwidth accounting — the paper's §3.5 formula.

    BW = sizeof(elem) * len(index) * count / time

The useful-bytes rate: data the pattern requests, cache reuse allowed.
Every number the port reports is this formula over a time measured on the
device the run used (the result names it).  The JAX package's modeled
column (``repro.core.bandwidth.tpu_tile_model``) models a TPU and has no
counterpart here yet.
"""
from __future__ import annotations

from .pattern import Pattern


def useful_bytes(p: Pattern, elem_bytes: int) -> int:
    """Paper §3.5 numerator: data actually requested."""
    return p.index_len * p.count * elem_bytes


def paper_bandwidth(p: Pattern, time_s: float, elem_bytes: int) -> float:
    """The paper's bandwidth formula, in bytes/s."""
    return useful_bytes(p, elem_bytes) / time_s
