"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention`` (``flash_attention_fwd``): one
launch computes the attention of every (batch row, KV head, query head)
with an online softmax, never writing the scores to device memory.  In
bfloat16 the products run on the tensor cores (wgmma, K/V tiles copied by
TMA); in float32 on the CUDA cores.  Any S and T run (no block multiple).
The head size is a template of the kernel: 64, 112 (kimi-k2-1t-a32b's:
the bf16 kernel runs DH 128's tile, its last 16 columns zero-filled by
TMA), 128 or 256 (recurrentgemma-9b's; the bf16 kernel takes 64 keys a
tile there, 128 at the others); on CUDA tensors any other raises, and so do more than 64
query heads per KV head (``check_kernel_shape``).  The plain version
takes any.

On CPU tensors the wrapper runs the plain version (``ref``); on CUDA
tensors it launches the kernel or raises.  q, k, v are all float32 or all
bfloat16, contiguous.

The gradient.  The JAX package's ``custom_vjp`` recomputes its backward
through the reference; here, where q, k or v requires grad on CUDA, the
call goes through ``FlashAttentionFn``: the forward kernel also writes each
query row's log-sum-exp (float32, (B, KVH, G, S)), and ``backward``
launches the backward kernel (``flash_attention_bwd``: dQ, dK, dV from q,
k, v, out, dO and that lse, FlashAttention-2's equations; bfloat16 in one
wgmma pass fed by TMA, dQ summed in a float32 workspace of q's shape that
the wrapper allocates; float32 on the CUDA cores; counted as
``flash_attention_bwd``, one a call).  Both are built at head sizes 64,
128 and 256 (``BWD_HEAD_DIMS``), with any window and softcap, carried from
the forward to the backward, except a softcap at 256 (no config has one:
the bfloat16 backward there is two mma.sync passes with a window and no
softcap, and needs no dQ workspace): on CUDA another head size with grad,
or a softcap at 256, raises, with no fallback.  Without grad the call
writes no lse.
On CPU tensors autograd differentiates the plain version, the JAX
``_bwd``'s own recompute.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

HEAD_DIMS = (64, 112, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)   # the backward's and the lse's instances
NO_CAP_BWD_HEAD_DIMS = (256,)    # backward instances without a softcap
MAX_GROUP = 64                  # a CTA's 64 (f32) or 128 rows: G x rows / G
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_backward(dh, softcap)
        return FlashAttentionFn.apply(q, k, v, scale, bool(causal),
                                      int(window), float(softcap))
    return _forward(dev, q, k, v, scale, causal, window, softcap)[0]


def check_backward(dh: int, softcap: float = 0.0) -> None:
    """Raise unless the backward kernel (and the forward's lse instance)
    takes head size ``dh`` with ``softcap``; any window runs."""
    if dh not in BWD_HEAD_DIMS:
        raise ValueError(f"no backward kernel at head size {dh}; built at "
                         f"{BWD_HEAD_DIMS} (ROADMAP A10.4: 112)")
    if softcap > 0 and dh in NO_CAP_BWD_HEAD_DIMS:
        raise ValueError(f"no backward kernel with a softcap at head size "
                         f"{dh}: no config caps its scores there")


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:            # 16-byte loads and TMA copies
            raise ValueError(f"{name}: data not 16-byte aligned")


def _forward(dev, q, k, v, scale, causal, window, softcap, with_lse=False):
    """Launch the forward kernel: (out, lse or None)."""
    _aligned(q=q, k=k, v=v)
    bsz, kvh, g, s, dh = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bsz, kvh, g, s), dtype=torch.float32, device=dev)
           if with_lse else None)
    if bsz * kvh * s:
        _build.launch("flash_attention", dev, "flash_attention",
                      _ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(), bsz, kvh, g,
                      s, k.shape[2], dh, scale, int(bool(causal)),
                      int(window), float(softcap))
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the backward kernel as its gradient (CUDA): the
    forward saves q, k, v, out and the row lse; the mask and the softcap
    reach both."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        out, lse = _forward(q.device, q, k, v, scale, causal, window,
                            softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """(dq, dk, dv) of flash attention from q, k, v, the forward's output
    ``o`` and row log-sum-exp ``lse`` (B,KVH,G,S) float32 (both from the
    same ``causal``, ``window`` and ``softcap``), and the gradient ``do``
    of ``o``: dq in q's shape, dk and dv in k's, each in the inputs'
    dtype.  On CPU tensors the plain version (``flash_attention_bwd_ref``:
    the JAX package's vjp, rows that the window leaves no key included); on
    CUDA the backward kernel (head sizes ``BWD_HEAD_DIMS``) or a raise."""
    _build.check_operand("q", q, getattr(q, "dtype", None), 5)
    if q.dtype not in _BWD_ENTRY:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    bsz, kvh, g, s, dh = q.shape
    for name, t in (("o", o), ("do", do)):
        _build.check_operand(name, t, q.dtype, 5)
        if t.shape != q.shape:
            raise ValueError(f"{name}: expected shape {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("k", k), ("v", v)):
        _build.check_operand(name, t, q.dtype, 4)
        if t.shape[:2] != (bsz, kvh) or t.shape[3] != dh or \
                t.shape != k.shape:
            raise ValueError(f"{name}: expected shape ({bsz}, {kvh}, T, "
                             f"{dh}), got {tuple(t.shape)}")
    _build.check_operand("lse", lse, torch.float32, 4)
    if tuple(lse.shape) != (bsz, kvh, g, s):
        raise ValueError(f"lse: expected shape {(bsz, kvh, g, s)}, got "
                         f"{tuple(lse.shape)}")
    t_len = k.shape[2]
    if t_len < 1:
        raise ValueError("k, v: no keys (T = 0)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dev = _build.common_device(q=q, k=k, v=v, o=o, lse=lse, do=do)
    if dev.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                       causal=causal, window=window,
                                       softcap=softcap)
    check_kernel_shape(dh, g)
    check_backward(dh, softcap)
    _aligned(q=q, k=k, v=v, o=o, do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bsz, kvh, g, s), dtype=torch.float32, device=dev)
    # bf16's wgmma pass sums dQ in float32 by L2 reductions (its delta pass
    # zeroes it); at dh 256 each dQ row is one thread's sum
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=dev)
              if q.dtype == torch.bfloat16 and dh not in NO_CAP_BWD_HEAD_DIMS
              else None)
    if bsz * kvh * s:
        _build.launch("flash_attention_bwd", dev, "flash_attention",
                      _BWD_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), delta.data_ptr(),
                      None if dq_acc is None else dq_acc.data_ptr(), bsz,
                      kvh, g, s, t_len, dh, float(scale), int(bool(causal)),
                      int(window), float(softcap))
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def flash_attention_lse(q, k, v, *, scale: float | None = None,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """(out, lse): the forward with each query row's log-sum-exp of its
    capped, masked scores, as the backward needs it (-1e30 for a row that
    the window leaves no key); on CPU tensors the plain version's
    (``flash_attention_ref(..., return_lse=True)``), on CUDA the kernel's
    lse instance (head sizes ``BWD_HEAD_DIMS``)."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    dev = _build.common_device(q=q, k=k, v=v)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap,
                                   return_lse=True)
    for name, t, nd in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        _build.check_operand(name, t, (torch.float32, torch.bfloat16), nd)
    check_kernel_shape(dh, q.shape[2])
    check_backward(dh)
    return _forward(dev, q, k, v, scale, causal, window, softcap,
                    with_lse=True)
