"""Wrapper of the Hopper selective-scan kernel (``csrc/selective_scan.cu``).

Replaces ``repro/kernels/selective_scan`` (``selective_scan_fwd``): one
launch computes the whole recurrence for every (batch row, channel) and
returns the final state beside the outputs, which a prefill keeps as the
decode cache.  Any L runs (no block multiple).  The state size N is a
template of the kernel: 4, 8 or 16, and any other N raises.

On CPU tensors the wrapper runs the plain version (``ref``); on CUDA
tensors it launches the kernel or raises.  u, dt, b, c are all float32 or
all bfloat16; a and d_skip are float32; everything is contiguous (the
model makes its column slices b, c of ``x_proj``'s output contiguous).

The gradient.  Where an operand requires grad, the call goes through
``SelectiveScanFn``: on CUDA its forward is the kernel's instance that also
writes the state before every ``CHUNK``-th step (the checkpoint, (B, L /
CHUNK, N, D) float32; ``selective_scan_ckpt_ref`` is its plain version),
and its backward launches the backward kernel (``selective_scan_bwd``,
counted as ``selective_scan_bwd``, one a call), which rebuilds each
chunk's states from that checkpoint and walks it in reverse.  On CPU
tensors the same Function runs the plain forward and the plain backward
(``selective_scan_bwd_ref``).  The gradients of u, dt, b and c come back
in u's dtype, those of a and d_skip in float32.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import selective_scan_bwd_ref, selective_scan_ref

STATE_SIZES = (4, 8, 16)
CHUNK = 8               # steps between checkpoints (the kernels' kCkptSteps)
CTA_CHANNELS = 128      # channels a backward CTA sums dB, dC over
_ENTRY = {torch.float32: "selective_scan_f32",
          torch.bfloat16: "selective_scan_bf16"}
_CKPT_ENTRY = {torch.float32: "selective_scan_ckpt_f32",
               torch.bfloat16: "selective_scan_ckpt_bf16"}
_BWD_ENTRY = {torch.float32: "selective_scan_bwd_f32",
              torch.bfloat16: "selective_scan_bwd_bf16"}


def _check(u, dt, b, c, a, d_skip):
    """Raise unless the operands are what the kernel takes: (B, L, D, N)."""
    _build.check_operand("u", u, getattr(u, "dtype", None), 3)
    if u.dtype not in _ENTRY:
        raise TypeError(f"u: expected float32 or bfloat16, got {u.dtype}")
    bsz, l, d = u.shape
    n = b.shape[-1] if isinstance(b, torch.Tensor) else -1
    if n not in STATE_SIZES:
        raise ValueError(f"state size N={n} not supported; the kernel takes "
                         f"N in {STATE_SIZES}")
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("dt", dt, u.dtype, (bsz, l, d)), ("b", b, u.dtype, (bsz, l, n)),
            ("c", c, u.dtype, (bsz, l, n)), ("a", a, f32, (n, d)),
            ("d_skip", d_skip, f32, (1, d))):
        _build.check_operand(name, t, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    return bsz, l, d, n


def selective_scan(u, dt, b, c, a, d_skip):
    """u, dt (B, L, D); b, c (B, L, N); a (N, D) < 0; d_skip (1, D).

    Returns (y (B, L, D) in u's dtype, h_final (B, N, D) float32).
    """
    _check(u, dt, b, c, a, d_skip)
    dev = _build.common_device(u=u, dt=dt, b=b, c=c, a=a, d_skip=d_skip)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, dt, b, c, a, d_skip)):
        return SelectiveScanFn.apply(u, dt, b, c, a, d_skip)
    if dev.type == "cpu":
        return selective_scan_ref(u, dt, b, c, a, d_skip)
    return _forward(dev, u, dt, b, c, a, d_skip)[:2]


def _forward(dev, u, dt, b, c, a, d_skip, with_ckpt=False):
    """Launch the forward kernel: (y, h_final, the checkpoint or None)."""
    bsz, l, d = u.shape
    n = b.shape[-1]
    y = torch.empty_like(u)
    h_final = torch.empty((bsz, n, d), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((bsz, -(-l // CHUNK), n, d), dtype=torch.float32,
                        device=dev) if with_ckpt else None)
    if bsz * d:
        args = [u.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                a.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
                h_final.data_ptr()]
        if with_ckpt:
            _build.launch("selective_scan", dev, "selective_scan",
                          _CKPT_ENTRY[u.dtype], *args, ckpt.data_ptr(), bsz,
                          l, d, n)
        else:
            _build.launch("selective_scan", dev, "selective_scan",
                          _ENTRY[u.dtype], *args, bsz, l, d, n)
    return y, h_final, ckpt


class SelectiveScanFn(torch.autograd.Function):
    """The scan with the backward kernel as its gradient (CUDA; the plain
    versions on the CPU): the forward saves its inputs and, on CUDA, the
    checkpoint of the states."""

    @staticmethod
    def forward(ctx, u, dt, b, c, a, d_skip):
        if u.device.type == "cpu":
            y, h_final = selective_scan_ref(u, dt, b, c, a, d_skip)
            ckpt = None
        else:
            y, h_final, ckpt = _forward(u.device, u, dt, b, c, a, d_skip,
                                        with_ckpt=True)
        ctx.save_for_backward(u, dt, b, c, a, d_skip, ckpt)
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        u, dt, b, c, a, d_skip, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        return selective_scan_bwd(u, dt, b, c, a, d_skip, dy, dh_final,
                                  ckpt)


def selective_scan_bwd(u, dt, b, c, a, d_skip, dy, dh_final=None,
                       ckpt=None):
    """(du, ddt, db, dc, da, dd_skip): the gradient of ``selective_scan``
    at its inputs, given ``dy`` (B, L, D) in u's dtype and ``dh_final`` (B,
    N, D) float32 or None (no cotangent of the final state); du, ddt, db,
    dc in u's dtype, da (N, D) and dd_skip (1, D) float32.  On CPU tensors
    the plain version (``selective_scan_bwd_ref``); on CUDA the backward
    kernel, from ``ckpt``, the checkpoint that the forward under grad wrote
    for these inputs, (B, ceil(L / CHUNK), N, D) float32."""
    bsz, l, d, n = _check(u, dt, b, c, a, d_skip)
    _build.check_operand("dy", dy, u.dtype, 3)
    if tuple(dy.shape) != (bsz, l, d):
        raise ValueError(f"dy: expected shape {(bsz, l, d)}, got "
                         f"{tuple(dy.shape)}")
    tensors = dict(u=u, dt=dt, b=b, c=c, a=a, d_skip=d_skip, dy=dy)
    if dh_final is not None:
        _build.check_operand("dh_final", dh_final, torch.float32, 3)
        if tuple(dh_final.shape) != (bsz, n, d):
            raise ValueError(f"dh_final: expected shape {(bsz, n, d)}, got "
                             f"{tuple(dh_final.shape)}")
        tensors["dh_final"] = dh_final
    dev = _build.common_device(**tensors)
    if dev.type == "cpu":
        return selective_scan_bwd_ref(u, dt, b, c, a, d_skip, dy, dh_final)
    want = (bsz, -(-l // CHUNK), n, d)
    _build.check_operand("ckpt", ckpt, torch.float32, 4)
    if tuple(ckpt.shape) != want or ckpt.device != dev:
        raise ValueError(f"ckpt: expected shape {want} on {dev}, got "
                         f"{tuple(ckpt.shape)} on {ckpt.device}")
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    f32 = torch.float32
    da = torch.empty((n, d), dtype=f32, device=dev)
    dd = torch.empty((1, d), dtype=f32, device=dev)
    if bsz * d == 0:
        return du, ddt, db, dc, da.zero_(), dd.zero_()
    part_bc = torch.empty((bsz, l, -(-d // CTA_CHANNELS), 2 * n), dtype=f32,
                          device=dev)
    part_a = torch.empty((bsz, n, d), dtype=f32, device=dev)
    part_d = torch.empty((bsz, d), dtype=f32, device=dev)
    _build.launch("selective_scan_bwd", dev, "selective_scan",
                  _BWD_ENTRY[u.dtype], u.data_ptr(), dt.data_ptr(),
                  b.data_ptr(), c.data_ptr(), a.data_ptr(), d_skip.data_ptr(),
                  dy.data_ptr(),
                  None if dh_final is None else dh_final.data_ptr(),
                  ckpt.data_ptr(), du.data_ptr(), ddt.data_ptr(),
                  db.data_ptr(), dc.data_ptr(), da.data_ptr(), dd.data_ptr(),
                  part_bc.data_ptr(), part_a.data_ptr(), part_d.data_ptr(),
                  bsz, l, d, n)
    return du, ddt, db, dc, da, dd


def bwd_kernel_attrs(dtype, n):
    """The backward kernel's resources on the current card at state size
    ``n`` (CUDA's function attributes and occupancy calculator), for the
    instance that 16-byte aligned operands take: registers and local bytes
    (spills) a thread, threads and dynamic shared bytes a CTA, CTAs an SM,
    channels a CTA, and whether its inputs come by cp.async.  Builds the
    library; launches nothing."""
    if dtype not in _BWD_ENTRY or n not in STATE_SIZES:
        raise ValueError(f"no backward instance for {dtype}, N={n}")
    out = (ctypes.c_int * 7)()
    err = _build.c_function("selective_scan", "selective_scan_bwd_attrs")(
        n, int(dtype == torch.bfloat16), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd_attrs: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "threads", "smem_bytes",
                     "ctas_per_sm", "channels_per_cta", "async"), out))
