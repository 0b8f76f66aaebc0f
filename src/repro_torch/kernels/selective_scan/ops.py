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
The kernel has no backward: on CUDA tensors with grad on and an operand
that requires it, the wrapper raises (``_build.refuse_grad``).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import selective_scan_ref

STATE_SIZES = (4, 8, 16)
_ENTRY = {torch.float32: "selective_scan_f32",
          torch.bfloat16: "selective_scan_bf16"}


def selective_scan(u, dt, b, c, a, d_skip):
    """u, dt (B, L, D); b, c (B, L, N); a (N, D) < 0; d_skip (1, D).

    Returns (y (B, L, D) in u's dtype, h_final (B, N, D) float32).
    """
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
    dev = _build.common_device(u=u, dt=dt, b=b, c=c, a=a, d_skip=d_skip)
    if dev.type == "cpu":
        return selective_scan_ref(u, dt, b, c, a, d_skip)
    _build.refuse_grad("selective_scan", u, dt, b, c, a, d_skip)
    y = torch.empty_like(u)
    h_final = torch.empty((bsz, n, d), dtype=torch.float32, device=dev)
    if bsz * d:
        _build.launch("selective_scan", dev, "selective_scan",
                      _ENTRY[u.dtype], u.data_ptr(), dt.data_ptr(),
                      b.data_ptr(), c.data_ptr(), a.data_ptr(),
                      d_skip.data_ptr(), y.data_ptr(), h_final.data_ptr(),
                      bsz, l, d, n)
    return y, h_final
