"""Mamba-1 selective-state-space mixer (falcon-mamba-7b).

The port of ``repro/models/ssm.py``, with its parameter names and layouts
and its cache ``{"conv": (B, d_conv-1, d_inner), "ssm": (B, d_inner, N)
float32}``.  The matrix products, the depthwise causal conv (the same sum
of shifted products) and the one-token decode update ``_scan_step`` are
plain torch, as they are plain ``jnp`` there.  The prefill's recurrence
goes through the Hopper selective-scan kernel (``kernels/selective_scan``)
on every device: on CPU tensors its wrapper runs the plain version.  The
kernel's final state is the decode cache, so a prefill hands decode the
state it needs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.selective_scan.ops import selective_scan
from .common import ParamDef, causal_conv, make_params


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def dt_rank(cfg) -> int:
    return cfg.ssm_dt_rank or (cfg.d_model + 15) // 16


def mamba_defs(cfg) -> dict:
    d, di, n, r, dc = (cfg.d_model, d_inner(cfg), cfg.ssm_state,
                       dt_rank(cfg), cfg.ssm_conv)
    return {
        "in_proj": ParamDef((d, 2 * di)),
        "conv_w": ParamDef((dc, di)),
        "conv_b": ParamDef((di,), init="zeros"),
        "x_proj": ParamDef((di, r + 2 * n)),
        "dt_proj": ParamDef((r, di)),
        "dt_bias": ParamDef((di,), init="zeros"),
        "a_log": ParamDef((di, n), init="zeros"),
        "d_skip": ParamDef((di,), init="ones"),
        "out_proj": ParamDef((di, d)),
    }


class Mamba(nn.Module):
    """The mixer's parameters, in the JAX package's names and layouts."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.defs = mamba_defs(cfg)
        make_params(self, self.defs, device, dtype)


def _ssm_inputs(cfg, p: Mamba, u: torch.Tensor):
    """u (B,S,di) -> (dt, B_mat, C_mat) for the selective scan."""
    n, r = cfg.ssm_state, dt_rank(cfg)
    xdbc = u @ p.x_proj                                     # (B,S,r+2n)
    dt_r, b_mat, c_mat = torch.split(xdbc, [r, n, n], dim=-1)
    dt = F.softplus(dt_r @ p.dt_proj + p.dt_bias)           # (B,S,di)
    return dt, b_mat, c_mat


def _scan_step(a_log, d_skip, h, inp):
    """h' = exp(dt*A) h + dt*B*u ; y = C·h + D*u   (single timestep)."""
    u_t, dt_t, b_t, c_t = inp   # (B,di) (B,di) (B,N) (B,N), float32
    a = -torch.exp(a_log.to(torch.float32))                 # (di, N)
    da = torch.exp(dt_t[..., None] * a)                     # (B,di,N)
    h = h * da + (dt_t * u_t)[..., None] * b_t[:, None, :]
    y = (h * c_t[:, None, :]).sum(-1) + d_skip * u_t
    return h, y


def mamba_prefill(cfg, p: Mamba, x: torch.Tensor):
    """Full-sequence mixer. x (B,S,d) -> (y (B,S,d), cache).

    The cache is what decode continues from: the pre-conv input's last
    d_conv-1 positions and the kernel's final state, (B, N, di) put into
    the cache layout (B, di, N).
    """
    xz = x @ p.in_proj
    u, z = xz.chunk(2, dim=-1)                              # (B,S,di) each
    u, conv_state = causal_conv(u, p.conv_w, p.conv_b)
    u = F.silu(u)
    dt, b_mat, c_mat = _ssm_inputs(cfg, p, u)
    a = -torch.exp(p.a_log.to(torch.float32)).T.contiguous()   # (N, di)
    # b, c are column slices of x_proj's output: the kernel takes them
    # contiguous (2 * B * S * N elements, 0.5 MB at 4 x 2048 tokens)
    ys, h_final = selective_scan(u, dt, b_mat.contiguous(),
                                 c_mat.contiguous(), a,
                                 p.d_skip[None].to(torch.float32))
    y = ys.to(x.dtype) * F.silu(z)
    out = (y @ p.out_proj).to(x.dtype)
    return out, {"conv": conv_state,
                 "ssm": h_final.transpose(1, 2).contiguous()}


def mamba_init_cache(cfg, batch: int, dtype, device) -> dict:
    di = d_inner(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(cfg, p: Mamba, x: torch.Tensor, cache: dict):
    """Single-token state update, x (B,1,d): O(1) in context length."""
    xz = x @ p.in_proj                                      # (B,1,2di)
    u, z = xz.chunk(2, dim=-1)
    u, conv_state = causal_conv(u, p.conv_w, p.conv_b, cache["conv"])
    u = F.silu(u)
    dt, b_mat, c_mat = _ssm_inputs(cfg, p, u)
    f32 = torch.float32
    h, y = _scan_step(p.a_log, p.d_skip, cache["ssm"],
                      (u[:, 0].to(f32), dt[:, 0].to(f32),
                       b_mat[:, 0].to(f32), c_mat[:, 0].to(f32)))
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = y @ p.out_proj
    return out, {"conv": conv_state, "ssm": h}
