"""RG-LRU recurrent block (recurrentgemma-9b, Griffin).

The port of ``repro/models/rglru.py``, with its parameter names and
layouts (``w_a`` and ``w_i`` dense (w, w)) and its cache ``{"conv": (B, 3,
w) in the model dtype, "h": (B, w) float32}``:

    r_t = sigmoid(x_t W_a + b_a),  i_t = sigmoid(x_t W_i + b_i)
    a_t = exp(8 r_t (-softplus(lam))),  beta_t = sqrt(max(1 - a_t^2, 1e-12))
    h_t = a_t h_{t-1} + beta_t (i_t x_t)

inside Griffin's block: a causal conv of width 4 on the input branch, a
GELU gate branch, the output projection.  The matrix products, the conv
(``common.causal_conv``) and the gates are plain torch, rounded where the
JAX package rounds: the conv sums its four shifted products in tap
order, r and i are sigmoids in the model dtype, softplus is taken in the
parameters' dtype and widened, log a and beta are float32, i x is
rounded in the model dtype and then widened, and h is rounded to the
model dtype before the gate.  The
recurrence runs through the Hopper kernel ``kernels/rglru_scan`` on every
device (its plain version on CPU tensors), in prefill and in decode (one
step, S = 1), so both share one arithmetic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rglru_scan.ops import rglru_scan
from .common import ParamDef, causal_conv, make_params

_C = 8.0
CONV = 4                      # the conv's taps; the cache keeps CONV - 1


def rglru_defs(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "in_x": ParamDef((d, w)),
        "in_gate": ParamDef((d, w)),
        "conv_w": ParamDef((CONV, w)),
        "conv_b": ParamDef((w,), init="zeros"),
        "w_a": ParamDef((w, w)),
        "b_a": ParamDef((w,), init="zeros"),
        "w_i": ParamDef((w, w)),
        "b_i": ParamDef((w,), init="zeros"),
        "lam": ParamDef((w,), init="ones"),
        "out_proj": ParamDef((w, d)),
    }


class RGLRU(nn.Module):
    """The block's parameters, in the JAX package's names and layouts."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.defs = rglru_defs(cfg)
        make_params(self, self.defs, device, dtype)


def _gates(p: RGLRU, x: torch.Tensor):
    """x (B,S,w) -> (a, beta) float32 and the input gate i (x's dtype)."""
    r = torch.sigmoid(x @ p.w_a + p.b_a)
    i = torch.sigmoid(x @ p.w_i + p.b_i)
    log_a_base = (-F.softplus(p.lam)).to(torch.float32)   # log sigmoid(lam)
    a = torch.exp(_C * r.to(torch.float32) * log_a_base)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta, i


def _mix(p: RGLRU, x: torch.Tensor, conv_state=None):
    """The branches around the recurrence: (a, beta, gx, gate, conv
    state)."""
    xb = x @ p.in_x
    gate = F.gelu(x @ p.in_gate, approximate="tanh")
    xb, conv_state = causal_conv(xb, p.conv_w, p.conv_b, conv_state)
    a, beta, i = _gates(p, xb)
    gx = (i * xb).to(torch.float32)
    return a, beta, gx, gate, conv_state


def rglru_prefill(cfg, p: RGLRU, x: torch.Tensor):
    """Full-sequence block. x (B,S,d) -> (y (B,S,d), cache): the cache is
    what decode continues from, the input branch's last 3 inputs before
    the conv and the recurrence's final state."""
    a, beta, gx, gate, conv_state = _mix(p, x)
    h0 = torch.zeros((x.shape[0], cfg.lru_width), dtype=torch.float32,
                     device=x.device)
    hs, h_last = rglru_scan(a, beta, gx, h0)
    y = hs.to(x.dtype) * gate
    return y @ p.out_proj, {"conv": conv_state, "h": h_last}


def rglru_init_cache(cfg, batch: int, dtype, device) -> dict:
    return {
        "conv": torch.zeros((batch, CONV - 1, cfg.lru_width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_decode(cfg, p: RGLRU, x: torch.Tensor, cache: dict):
    """Single-token update, x (B,1,d): O(1) in context length.  The step
    runs through the recurrence kernel at S = 1."""
    a, beta, gx, gate, conv_state = _mix(p, x, cache["conv"])
    _, h = rglru_scan(a, beta, gx, cache["h"])
    y = h[:, None].to(x.dtype) * gate
    return y @ p.out_proj, {"conv": conv_state, "h": h}
