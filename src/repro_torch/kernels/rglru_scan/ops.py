"""Wrapper of the Hopper RG-LRU recurrence kernel (``csrc/rglru_scan.cu``).

Replaces no TPU kernel: the JAX package runs the RG-LRU recurrence
(``repro/models/rglru.py``, ``_step`` under ``lax.scan``) as one loop on
the device, in plain ``jnp``, and no PyTorch call computes a linear
recurrence, so a loop of per-step torch ops would launch several kernels a
step (26 layers x 8,192 steps a recurrentgemma-9b prefill).  One launch
computes h_t = a_t h_{t-1} + beta_t gx_t for every (batch row, channel)
over all S steps, from h0, in the order of ``ref.rglru_scan_ref``, and
returns every h_t and h_S.  Any B, S, W run; decode runs its one step
through the same launch at S = 1.

On CPU tensors the wrapper runs the plain version (``ref``); on CUDA
tensors it launches the kernel or raises.  Every operand is float32 and
contiguous.
The kernel has no backward: on CUDA tensors with grad on and an operand
that requires it, the wrapper raises (``_build.refuse_grad``).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import rglru_scan_ref


def rglru_scan(a, beta, gx, h0):
    """a, beta, gx (B, S, W) float32; h0 (B, W) float32 -> (hs (B, S, W),
    h_S (B, W)), float32."""
    f32 = torch.float32
    _build.check_operand("a", a, f32, 3)
    bsz, s, w = a.shape
    for name, t, shape in (("beta", beta, (bsz, s, w)),
                           ("gx", gx, (bsz, s, w)), ("h0", h0, (bsz, w))):
        _build.check_operand(name, t, f32, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    dev = _build.common_device(a=a, beta=beta, gx=gx, h0=h0)
    if dev.type == "cpu":
        return rglru_scan_ref(a, beta, gx, h0)
    _build.refuse_grad("rglru_scan", a, beta, gx, h0)
    hs = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if bsz * w:
        _build.launch("rglru_scan", dev, "rglru_scan", "rglru_scan_f32",
                      a.data_ptr(), beta.data_ptr(), gx.data_ptr(),
                      h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(), bsz,
                      s, w)
    return hs, h_last
