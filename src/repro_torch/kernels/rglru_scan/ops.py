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

The gradient.  Where an operand requires grad, the call goes through
``RGLRUScanFn``, which saves the inputs and every h_t; its backward
launches the backward kernel on CUDA (``rglru_scan_bwd``, counted as
``rglru_scan_bwd``, one a call) and runs the plain backward
(``rglru_scan_bwd_ref``, the same bits) on the CPU.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import rglru_scan_bwd_ref, rglru_scan_ref


def _check(a, beta, gx, h0):
    """Raise unless the operands are what the kernel takes: (B, S, W)."""
    f32 = torch.float32
    _build.check_operand("a", a, f32, 3)
    bsz, s, w = a.shape
    for name, t, shape in (("beta", beta, (bsz, s, w)),
                           ("gx", gx, (bsz, s, w)), ("h0", h0, (bsz, w))):
        _build.check_operand(name, t, f32, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    return bsz, s, w


def rglru_scan(a, beta, gx, h0):
    """a, beta, gx (B, S, W) float32; h0 (B, W) float32 -> (hs (B, S, W),
    h_S (B, W)), float32."""
    _check(a, beta, gx, h0)
    dev = _build.common_device(a=a, beta=beta, gx=gx, h0=h0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (a, beta, gx, h0)):
        return RGLRUScanFn.apply(a, beta, gx, h0)
    if dev.type == "cpu":
        return rglru_scan_ref(a, beta, gx, h0)
    return _forward(dev, a, beta, gx, h0)


def _forward(dev, a, beta, gx, h0):
    bsz, s, w = a.shape
    hs = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if bsz * w:
        _build.launch("rglru_scan", dev, "rglru_scan", "rglru_scan_f32",
                      a.data_ptr(), beta.data_ptr(), gx.data_ptr(),
                      h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(), bsz,
                      s, w)
    return hs, h_last


class RGLRUScanFn(torch.autograd.Function):
    """The recurrence with the backward kernel as its gradient (CUDA; the
    plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, a, beta, gx, h0):
        if a.device.type == "cpu":
            hs, h_last = rglru_scan_ref(a, beta, gx, h0)
        else:
            hs, h_last = _forward(a.device, a, beta, gx, h0)
        ctx.save_for_backward(a, beta, gx, h0, hs)
        ctx.set_materialize_grads(False)
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        a, beta, gx, h0, hs = ctx.saved_tensors
        dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        return rglru_scan_bwd(a, beta, gx, h0, hs, dhs, dh_last)


def rglru_scan_bwd(a, beta, gx, h0, hs, dhs, dh_last=None):
    """(da, dbeta, dgx, dh0): the gradient of ``rglru_scan`` at its inputs,
    from its output ``hs`` and the cotangents ``dhs`` (B, S, W) and
    ``dh_last`` (B, W) or None, all float32.  On CPU tensors the plain
    version (``rglru_scan_bwd_ref``); on CUDA the backward kernel, the same
    bits."""
    bsz, s, w = _check(a, beta, gx, h0)
    tensors = dict(a=a, beta=beta, gx=gx, h0=h0, hs=hs, dhs=dhs)
    for name, t in (("hs", hs), ("dhs", dhs)) + (
            (("dh_last", dh_last),) if dh_last is not None else ()):
        shape = (bsz, w) if name == "dh_last" else (bsz, s, w)
        _build.check_operand(name, t, torch.float32, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        tensors[name] = t
    dev = _build.common_device(**tensors)
    if dev.type == "cpu":
        return rglru_scan_bwd_ref(a, beta, gx, h0, hs, dhs, dh_last)
    da, dbeta, dgx = (torch.empty_like(a) for _ in range(3))
    dh0 = torch.empty_like(h0)
    if bsz * w:
        _build.launch("rglru_scan_bwd", dev, "rglru_scan",
                      "rglru_scan_bwd_f32", a.data_ptr(), beta.data_ptr(),
                      gx.data_ptr(), h0.data_ptr(), hs.data_ptr(),
                      dhs.data_ptr(),
                      None if dh_last is None else dh_last.data_ptr(),
                      da.data_ptr(), dbeta.data_ptr(), dgx.data_ptr(),
                      dh0.data_ptr(), bsz, s, w)
    return da, dbeta, dgx, dh0
