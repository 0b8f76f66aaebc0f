"""Wrapper of the Hopper paged-decode kernel (``csrc/paged_decode.cu``).

Replaces ``repro/kernels/paged_decode`` (``paged_decode_kernel``): one
launch attends every (batch row, KV head) over the pages its table row
names, up to its length, with an online softmax, gathering each K/V row
through the table as it reads it.  Any page size; repeated pages are fine.
The head size (64 or 128) and the query heads per KV head (1, 2, 4, 8 or
16) are templates of the kernel: on CUDA tensors others raise
(``check_kernel_shape``).  The plain version takes any.

On CPU tensors the wrapper runs the plain version (``ref``); on CUDA
tensors it launches the kernel or raises.  q and the pages are all float32
or all bfloat16; the table and lengths are int32; everything is
contiguous.  Lengths lie in [1, pages_per_seq * page] and table entries in
[0, P): the plain version raises on an entry outside, the kernel clamps it
(it is not checked on the card, which would cost a synchronisation).
"""
from __future__ import annotations

import math

import torch

from .. import _build
from .ref import paged_decode_attention_ref

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8, 16)
_ENTRY = {torch.float32: "paged_decode_f32",
          torch.bfloat16: "paged_decode_bf16"}


def check_kernel_shape(dh: int, g: int) -> None:
    """Raise unless the kernel takes head size ``dh`` and ``g`` query heads
    per KV head."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} not supported; the kernel takes "
                         f"dh in {HEAD_DIMS}")
    if g not in GROUPS:
        raise ValueError(f"{g} query heads per KV head not supported; the "
                         f"kernel takes G in {GROUPS}")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale: float | None = None):
    """q (B, KVH, G, dh); k_pages/v_pages (KVH, P, page, dh); page_table
    (B, pages_per_seq) int32; lengths (B,) int32 -> (B, KVH, G, dh).

    ``scale=None`` means 1/sqrt(dh).
    """
    _build.check_operand("q", q, getattr(q, "dtype", None), 4)
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    bsz, kvh, g, dh = q.shape
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _build.check_operand(name, t, q.dtype, 4)
        if t.shape[0] != kvh or t.shape[3] != dh:
            raise ValueError(f"{name}: expected shape ({kvh}, P, page, {dh}), "
                             f"got {tuple(t.shape)}")
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"v_pages: expected shape {tuple(k_pages.shape)}, "
                         f"got {tuple(v_pages.shape)}")
    _build.check_operand("page_table", page_table, torch.int32, 2)
    _build.check_operand("lengths", lengths, torch.int32, 1)
    if page_table.shape[0] != bsz or tuple(lengths.shape) != (bsz,):
        raise ValueError(f"page_table {tuple(page_table.shape)} and lengths "
                         f"{tuple(lengths.shape)} must have {bsz} rows")
    _, n_pages, page, _ = k_pages.shape
    pps = page_table.shape[1]
    if n_pages < 1 or page < 1 or pps < 1:
        raise ValueError(f"empty pool or table: pages {tuple(k_pages.shape)},"
                         f" table {tuple(page_table.shape)}")
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    dev = _build.common_device(q=q, k_pages=k_pages, v_pages=v_pages,
                               page_table=page_table, lengths=lengths)
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          lengths, scale=scale)
    check_kernel_shape(dh, g)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:            # the kernel reads 16 bytes at a time
            raise ValueError(f"{name}: data not 16-byte aligned")
    out = torch.empty_like(q)
    if bsz * kvh:
        _build.launch("paged_decode", dev, "paged_decode", _ENTRY[q.dtype],
                      q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      page_table.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), bsz, kvh, g, n_pages, page, pps, dh,
                      scale)
    return out
