"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention`` (``flash_attention_fwd``): one
launch computes the attention of every (batch row, KV head, query head)
with an online softmax, never writing the scores to device memory.  In
bfloat16 the products run on the tensor cores (wgmma, K/V tiles copied by
TMA); in float32 on the CUDA cores.  Any S and T run (no block multiple).
The head size is a template of the kernel: 64 or 128; on CUDA tensors any
other raises, and so do more than 64 query heads per KV head
(``check_kernel_shape``).  The plain version takes any.

On CPU tensors the wrapper runs the plain version (``ref``); on CUDA
tensors it launches the kernel or raises.  q, k, v are all float32 or all
bfloat16, contiguous.  Only the forward: the JAX package's backward
recomputes through its reference, and the port does not train yet.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from .ref import flash_attention_ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 64                  # a CTA's 64 (f32) or 128 rows: G x rows / G
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def check_kernel_shape(dh: int, g: int) -> None:
    """Raise unless the kernel takes head size ``dh`` and ``g`` query heads
    per KV head."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} not supported; the kernel takes "
                         f"dh in {HEAD_DIMS}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"{g} query heads per KV head; the kernel takes "
                         f"1..{MAX_GROUP}")


def flash_attention(q, k, v, *, scale: float | None = None,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q (B,KVH,G,S,dh); k/v (B,KVH,T,dh) -> (B,KVH,G,S,dh) in q's dtype.

    ``scale=None`` means 1/sqrt(dh).  ``causal`` keeps keys j <= i, a
    ``window`` > 0 keys with i - j < window, a ``softcap`` > 0 caps the
    scores with tanh.  A query row that the window leaves no key (i >= T +
    window - 1) gets the reference's answer: every score masked to -1e30,
    so uniform weights, the mean of v over all T keys.
    """
    _build.check_operand("q", q, getattr(q, "dtype", None), 5)
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    bsz, kvh, g, s, dh = q.shape
    for name, t in (("k", k), ("v", v)):
        _build.check_operand(name, t, q.dtype, 4)
        if t.shape[:2] != (bsz, kvh) or t.shape[3] != dh:
            raise ValueError(f"{name}: expected shape ({bsz}, {kvh}, T, "
                             f"{dh}), got {tuple(t.shape)}")
    t_len = k.shape[2]
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v: expected shape {tuple(k.shape)}, got "
                         f"{tuple(v.shape)}")
    if t_len < 1:
        raise ValueError("k, v: no keys (T = 0)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    dev = _build.common_device(q=q, k=k, v=v)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap)
    check_kernel_shape(dh, g)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:            # 16-byte loads and TMA copies
            raise ValueError(f"{name}: data not 16-byte aligned")
    out = torch.empty_like(q)
    if bsz * kvh * s:
        _build.launch("flash_attention", dev, "flash_attention",
                      _ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), bsz, kvh, g, s, t_len,
                      dh, scale, int(bool(causal)), int(window),
                      float(softcap))
    return out
